"""Mean host milliseconds of an ``engine.setup`` span of the windowed
engine on the churn cell: ``WindowedStepper.__init__``, which builds
the state's (N, W) planes and the (N, K) tables, the free slot
included, once a repetition."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "engine.setup")
