"""Mean host milliseconds of a ``segment.dispatch`` span of the windowed
engine (activation and the enqueue of the segment's rounds)."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "segment.dispatch")
