"""Kernels of the device trace (every one, not copies or fills) over the
rounds the window simulated."""

from causal_bench.harness.readers import launches_per_round


def read(ctx):
    return launches_per_round(ctx)
