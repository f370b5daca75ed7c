"""Mean host milliseconds of a ``segment.retire`` span of the windowed
engine: the (N, K) tables read, the retirement reductions, the gates'
masks (``retire.gates``) and the fold of the retiring columns; the
wait for the segment's rounds lies before it, in ``segment.wait``."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "segment.retire")
