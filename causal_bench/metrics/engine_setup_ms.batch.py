"""Mean host milliseconds of an ``engine.setup`` span of the windowed
engine: ``WindowedStepper.__init__``, which builds the state's (N, W)
planes on the host and copies them to the card, once a repetition."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "engine.setup")
