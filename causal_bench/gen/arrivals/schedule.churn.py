"""``schedule.churn``: Poisson broadcasts with Fig. 7's churn batches.

The broadcasts are ``schedule.poisson``'s draw (``rate`` a round,
origins distinct within a round, ``messages`` of them, from ``seed +
1``).  From ``seed + 3``, as ``churn_scenario`` seeds its churn, come
link changes in batches: batch ``j >= 1`` covers rounds ``[period * j,
period * j + batch_rounds)`` and is drawn for every batch that ends
before the last broadcast round.  A batch is

* ``adds`` link additions on the free slot ``k - 1``, uniform over its
  rounds, each from a process not yet used by any batch (the batches
  share one permutation of the processes, as ``churn_wave_scenario``'s
  waves share their pool), to a target outside the process's initial
  out-view, with a delay drawn from ``[1, max_delay]``;
* up to ``removals`` removals of initially populated slots ``1 ..
  k - 2`` (never the ring's slot 0, never the addition slot), uniform
  over its rounds; a draw of a slot already removed is dropped.

:func:`plan_adds` is a frozen copy of ``_plan_adds`` of
``repro_torch.core.vecsim.scenario`` (which draws its processes itself
unless ``procs`` is given) and :func:`plan_removals` of the removal
draw of ``churn_wave_scenario``: copied, not imported, so that a change
to the program never changes the inputs it is measured on.  The
scenario runs to the last event plus the overlay's settle time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from causal_bench.gen.draw import schedule_inputs
from causal_bench.harness.spec import load_file

__all__ = ["inputs", "plan_adds", "plan_removals", "churn_batches"]

_FIELDS_ADD = ("add_round", "add_p", "add_k", "add_q", "add_delay")
_FIELDS_RM = ("rm_round", "rm_p", "rm_k")


def _i32(a) -> np.ndarray:
    return np.asarray(a, np.int32)


def plan_adds(rng, n: int, k: int, adj0: np.ndarray, n_adds: int,
              lo: int, hi: int, max_delay: int,
              procs: Optional[np.ndarray] = None):
    """Link additions on the free slot ``k - 1`` of distinct processes,
    each to a process not in the adder's initial out-view, at rounds
    ``[lo, hi)``; round-sorted ``(round, p, k, q, delay)`` int32."""
    hi = max(hi, lo + 1)
    if procs is None:
        procs = rng.choice(n, size=min(n_adds, n), replace=False)
    add_round, add_p, add_k, add_q, add_delay = [], [], [], [], []
    for p in procs:
        p = int(p)
        used = {p} | {int(q) for q in adj0[p] if q >= 0}
        if len(used) >= n:
            continue
        while True:
            q = int(rng.integers(0, n))
            if q not in used:
                break
        add_round.append(int(rng.integers(lo, hi)))
        add_p.append(p)
        add_k.append(k - 1)
        add_q.append(q)
        add_delay.append(int(rng.integers(1, max_delay + 1)))
    order = np.argsort(np.asarray(add_round), kind="stable")
    return tuple(_i32(np.asarray(a)[order]) for a in
                 (add_round, add_p, add_k, add_q, add_delay))


def plan_removals(rng, n: int, k: int, adj0: np.ndarray, n_rms: int,
                  lo: int, hi: int, seen: set):
    """Up to ``n_rms`` removals of populated slots ``1 .. k - 2`` at
    rounds ``[lo, hi)``, none of a slot in ``seen`` (which grows);
    ``(round, p, k)`` lists in draw order."""
    rm_round, rm_p, rm_k = [], [], []
    for _ in range(n_rms):
        p = int(rng.integers(0, n))
        kk = int(rng.integers(1, max(2, k - 1)))
        if adj0[p, kk] >= 0 and (p, kk) not in seen:
            seen.add((p, kk))
            rm_round.append(int(rng.integers(lo, hi)))
            rm_p.append(p)
            rm_k.append(kk)
    return rm_round, rm_p, rm_k


def churn_batches(seed: int, cfg: dict, mix: dict, adj0: np.ndarray,
                  last_round: int) -> dict:
    """Every batch that ends before ``last_round``, merged and
    round-sorted: the ``add_*`` and ``rm_*`` arrays."""
    n, k = int(cfg["n"]), int(cfg["k"])
    period, span = int(mix["period"]), int(mix["batch_rounds"])
    rng = np.random.default_rng(seed)
    pool = rng.permutation(n)
    at, seen = 0, set()
    adds = [[] for _ in _FIELDS_ADD]
    rms = [[] for _ in _FIELDS_RM]
    j = 1
    while period * j + span <= last_round:
        lo, hi = period * j, period * j + span
        procs = pool[at: at + int(mix["adds"])]
        at += len(procs)
        for acc, col in zip(adds, plan_adds(rng, n, k, adj0, len(procs),
                                            lo, hi, int(cfg["max_delay"]),
                                            procs=procs)):
            acc.extend(col.tolist())
        for acc, col in zip(rms, plan_removals(rng, n, k, adj0,
                                               int(mix["removals"]), lo, hi,
                                               seen)):
            acc.extend(col)
        j += 1
    out = {}
    for names, cols in ((_FIELDS_ADD, adds), (_FIELDS_RM, rms)):
        order = np.argsort(np.asarray(cols[0], np.int64), kind="stable")
        out.update({name: _i32(np.asarray(col, np.int64)[order])
                    for name, col in zip(names, cols)})
    return out


def inputs(cfg: dict, mix: dict, seed: int, adj0) -> dict:
    poisson = load_file("gen/arrivals", "schedule.poisson").poisson_schedule
    out = schedule_inputs(cfg, mix, seed, adj0, poisson, float(mix["rate"]))
    r = out["bcast_round"]
    last_bc = int(r[-1]) if len(r) else 0
    out.update(churn_batches(seed + 3, cfg, mix, adj0, last_bc))
    last = max([last_bc] + [int(out[f].max()) for f in ("add_round",
                                                        "rm_round")
                            if len(out[f])])
    # the last event plus the settle time, as the broadcasts' rounds are
    out["rounds"] += last - last_bc
    return out
