"""Mean host milliseconds of an ``engine.finish`` span of the windowed
engine on the churn cell: the drain's fold of the columns still live,
the gate-held and ping columns among them, and the read of the final
state back to the host, once a repetition."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "engine.finish")
