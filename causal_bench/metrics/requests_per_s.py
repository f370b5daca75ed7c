"""Submissions served to full delivery in the window, over the window's
wall seconds; a shed or unserved submission is not served."""

from causal_bench.harness.readers import rate


def read(ctx):
    return rate(ctx, "requests")
