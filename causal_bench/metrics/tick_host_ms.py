"""Host milliseconds a serving tick spends in ingest and admission (the
``tick.ingest`` and ``tick.admit`` spans), per tick."""

from causal_bench.harness.readers import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, ("tick.ingest", "tick.admit"))
