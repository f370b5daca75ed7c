"""Mean host milliseconds of a ``segment.enqueue`` span of the windowed
engine: ``run_span``, the enqueue of the segment's rounds (their
events, masks, sweeps and stats rows), with no wait for the card."""

from causal_bench.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "segment.enqueue")
