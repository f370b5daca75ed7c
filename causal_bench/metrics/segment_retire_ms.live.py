"""Mean host milliseconds of a ``segment.retire`` span of the windowed
engine: the wait for the segment's rounds on the card, the retirement
reductions and the host fold of the retiring columns."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "segment.retire")
