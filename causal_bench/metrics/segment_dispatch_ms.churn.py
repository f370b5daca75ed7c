"""Mean host milliseconds of a ``segment.dispatch`` span of the windowed
engine on the churn cell: the activation, the upload of the segment's
schedule with its link additions and removals, and the enqueue of its
gated rounds."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "segment.dispatch")
