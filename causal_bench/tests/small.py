"""Small copies of the benchmark's cells, for the CPU tests: each cell's
configuration and mix at a size a test run holds, through the same
drivers, references and harness as the cells on the card."""

from __future__ import annotations

from causal_bench.harness.spec import load_cell

__all__ = ["SMALL", "small_spec"]

#: cell -> (configuration overrides, traffic overrides)
SMALL = {
    "kreg10k.poisson": (dict(n=300, window=512),
                        dict(rate=20.0, messages=2000)),
    "kreg64k.bursty": (dict(n=400, window=64, queue_cap=4096,
                            per_round_cap=12),
                       dict(rate=4.0, rate_lo=1.0, period=256, duty=0.1,
                            messages=1500)),
}


def small_spec(name: str):
    spec = load_cell(name)
    cfg, mix = SMALL[name]
    spec.config.update(cfg)
    spec.traffic.update(mix)
    return spec
