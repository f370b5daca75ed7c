"""Percent of the traced window in which nothing ran on the card."""

from causal_bench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
