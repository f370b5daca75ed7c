"""``schedule.poisson``: a pre-scripted broadcast schedule of Poisson
(``rate``) broadcasts a round, origins distinct within a round — a
frozen copy of ``poisson_traffic`` of ``repro_torch.core.vecsim.
scenario``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from causal_bench.gen.draw import per_round_origins, schedule_inputs

__all__ = ["inputs", "poisson_schedule"]


def poisson_schedule(seed: int, n: int, t0: int, t1: int,
                     max_messages: Optional[int], p: dict):
    """Poisson(``rate``) broadcasts per round over ``[t0, t1)``."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(p["rate"], size=max(0, t1 - t0))
    r, o = per_round_origins(rng, n, counts, t0)
    return r[:max_messages], o[:max_messages]


def inputs(cfg: dict, mix: dict, seed: int, adj0) -> dict:
    return schedule_inputs(cfg, mix, seed, adj0, poisson_schedule,
                           float(mix["rate"]))
