"""Mean host milliseconds of a ``segment.wait`` span of the windowed
engine on the churn cell: the read of the segment's stats rows, in
which the host waits for the segment's gated rounds on the card."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "segment.wait")
