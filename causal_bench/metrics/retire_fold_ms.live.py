"""Mean host milliseconds of a ``retire.fold`` span of the windowed
engine: the fold of a segment's retiring columns into the aggregates
(latency histogram, origin deliveries) and their reset on the card."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "retire.fold")
