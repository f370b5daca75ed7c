"""``submissions.bursty``: an open-loop submission trace, Poisson at
``rate_lo`` a round with spike windows at ``rate`` — the first ``duty``
of every ``period`` rounds — origins uniform with replacement; a frozen
copy of ``_bursty`` of ``repro_torch.core.vecsim.live.arrivals``."""

from __future__ import annotations

import numpy as np

from causal_bench.gen.draw import from_lambda, submission_inputs

__all__ = ["inputs", "bursty_submissions"]


def bursty_submissions(rng, n: int, messages: int, p: dict):
    period = max(1, int(p.get("period", 256)))
    duty = float(p.get("duty", 0.25))
    rate, rate_lo = p["rate"], p.get("rate_lo")
    if rate_lo is None:
        rate_lo = rate / 8.0
    on = max(1, int(round(duty * period)))
    return from_lambda(
        rng, n, messages,
        lambda t: np.where((t % period) < on, rate, rate_lo))


def inputs(cfg: dict, mix: dict, seed: int, adj0) -> dict:
    return submission_inputs(cfg, mix, seed, adj0, bursty_submissions)
