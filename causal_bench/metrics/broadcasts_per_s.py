"""Broadcasts delivered to every correct process in the window, over the
window's wall seconds (host clock, ended by a device sync)."""

from causal_bench.harness.readers import rate


def read(ctx):
    return rate(ctx, "broadcasts")
