"""What the arrival processes (``gen/arrivals/<name>.py``) share: frozen
copies of the program's per-round draws, and the two forms of a cell's
traffic inputs.

* a **schedule** — a pre-scripted broadcast schedule for the batch
  engines: per round a count of broadcasts whose origins are drawn
  without replacement, so every ``(origin, round)`` is unique (a copy
  of ``_per_round_origins`` of ``repro_torch.core.vecsim.scenario``),
  drawn from ``seed + 1`` over a span long enough for ``messages``;
  the scenario runs to the last broadcast plus the overlay's settle
  time, as ``sustained_scenario`` sizes it;
* **submissions** — an open-loop ``(round, origin)`` trace for the live
  serving loop, origins uniform with replacement (a copy of
  ``_from_lambda`` of ``repro_torch.core.vecsim.live.arrivals``), drawn
  from ``seed + 1``, over a broadcast-free base whose ``rounds`` is the
  settle time plus the configuration's ``base_rounds_pad``.

Every array is round-sorted int32.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from .rounds import diameter_bound, settle_rounds

__all__ = ["per_round_origins", "from_lambda", "schedule_inputs",
           "submission_inputs"]

Pair = Tuple[np.ndarray, np.ndarray]


def per_round_origins(rng, n: int, counts: np.ndarray, t0: int) -> Pair:
    rounds, origins = [], []
    for off, c in enumerate(counts):
        c = int(min(c, n))
        if c <= 0:
            continue
        rounds.extend([t0 + off] * c)
        origins.extend(rng.choice(n, size=c, replace=False).tolist())
    return np.asarray(rounds, np.int32), np.asarray(origins, np.int32)


def from_lambda(rng, n: int, messages: int, lam_fn) -> Pair:
    """Poisson per-round counts under the intensity ``lam_fn(t)``, drawn
    1,024 rounds at a time until ``messages`` submissions exist."""
    chunks = []
    t0, total = 0, 0
    while total < messages:
        span = 1024
        lam = np.maximum(0.0, np.asarray(
            lam_fn(np.arange(t0, t0 + span)), float))
        if total == 0 and t0 > (1 << 22):
            raise ValueError("arrival intensity never produced traffic")
        cnt = rng.poisson(lam)
        chunks.append(cnt)
        total += int(cnt.sum())
        t0 += span
    counts = np.concatenate(chunks)
    rounds = np.repeat(np.arange(len(counts)),
                       counts)[:messages].astype(np.int32)
    origins = rng.integers(0, n, messages).astype(np.int32)
    return rounds, origins


def _settle(cfg: dict, adj0) -> int:
    return settle_rounds(cfg["n"], cfg["k"], cfg["max_delay"],
                         cfg["pong_delay"], diam=diameter_bound(adj0))


def schedule_inputs(cfg: dict, mix: dict, seed: int, adj0,
                    build: Callable[..., Pair], mean_rate: float) -> Dict:
    """A schedule of ``mix["messages"]`` broadcasts from
    ``build(seed, n, t0, t1, max_messages, mix)``, whose mean is
    ``mean_rate`` broadcasts a round."""
    messages = int(mix["messages"])
    span = max(8, int(np.ceil(messages / max(mean_rate, 1e-9) * 1.25)))
    for _ in range(16):
        r, o = build(seed + 1, cfg["n"], 0, span, messages, mix)
        if len(r) == messages:
            break
        span *= 2
    if len(r) != messages:
        raise ValueError(f"traffic span too short: {len(r)} < {messages}")
    last = int(r[-1]) if len(r) else 0
    return dict(bcast_round=r, bcast_origin=o,
                rounds=last + 1 + _settle(cfg, adj0))


def submission_inputs(cfg: dict, mix: dict, seed: int, adj0,
                      build: Callable[..., Pair]) -> Dict:
    """A trace of ``mix["messages"]`` submissions from
    ``build(rng, n, messages, mix)``."""
    rng = np.random.default_rng(seed + 1)
    r, o = build(rng, cfg["n"], int(mix["messages"]), mix)
    return dict(arr_round=r, arr_origin=o,
                rounds=cfg["base_rounds_pad"] + _settle(cfg, adj0),
                bcast_round=np.zeros(0, np.int32),
                bcast_origin=np.zeros(0, np.int32))
