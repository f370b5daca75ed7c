"""Tensorized protocol-engine state and schedules.

The port's copy of the JAX package's ``core/engine/state.py`` (numpy,
unchanged in behaviour): the event-driven simulation becomes a
bulk-synchronous round simulation over dense arrays.

  * time      — integer rounds; a message sent on a link with delay ``d`` at
    round ``t`` arrives at round ``t+d``; constant (or non-decreasing)
    per-link delays make FIFO automatic;
  * messages  — global slots ``0..M-1``; slots ``[0, m_app)`` are
    application broadcasts, slots ``[m_app, M)`` are ping messages, one per
    scheduled link addition (pings flood over safe links exactly like app
    messages — the paper's "ping travels using safe links");
  * state     — ``arr[q, m]``: earliest known arrival round of message m at
    process q; ``delivered[q, m]``: delivery round (-1 = not yet);
    per-link-slot arrays over ``(N, K)`` for adjacency, delay, activity and
    the ping-phase machinery (gate round, flush round, ping slot).

Everything is preplanned (schedules are dense arrays), so a round's events
are known on the host before the round runs (``step.py``), and the
process axis splits over ranks (``sharded.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["INF", "EngineConfig", "Schedule", "build_state", "random_instance"]

INF = np.int32(2**30)


@dataclass(frozen=True)
class EngineConfig:
    n: int                      # processes
    k: int                      # out-link slots per process
    rounds: int                 # simulated rounds
    mode: str = "pc"            # "pc" (safe links) | "r" (use all links)
    pong_delay: int = 1         # rounds for rho to return (any channel)
    always_gate: bool = False   # paper-faithful unconditional gating

    def __post_init__(self):
        assert self.mode in ("pc", "r")


@dataclass
class Schedule:
    """Preplanned run: broadcasts + link churn, all numpy int32 arrays."""

    # broadcasts: message slot i is broadcast by origin[i] at round[i]
    bcast_round: np.ndarray      # (M_app,)
    bcast_origin: np.ndarray     # (M_app,)
    # link additions: at round, set adj[p, k] = q  (one ping slot each)
    add_round: np.ndarray        # (E,)
    add_p: np.ndarray            # (E,)
    add_k: np.ndarray            # (E,)
    add_q: np.ndarray            # (E,)
    add_delay: np.ndarray        # (E,)
    # link removals: at round, deactivate slot (p, k)
    rm_round: np.ndarray         # (R,)
    rm_p: np.ndarray             # (R,)
    rm_k: np.ndarray             # (R,)

    @property
    def m_app(self) -> int:
        return len(self.bcast_round)

    @property
    def n_adds(self) -> int:
        return len(self.add_round)

    @property
    def m_total(self) -> int:
        return self.m_app + self.n_adds

    @staticmethod
    def empty_churn(bcast_round, bcast_origin) -> "Schedule":
        z = np.zeros((0,), np.int32)
        return Schedule(np.asarray(bcast_round, np.int32),
                        np.asarray(bcast_origin, np.int32),
                        z, z, z, z, z, z, z, z)


def build_state(cfg: EngineConfig, sched: Schedule, adj0: np.ndarray,
                delay0: np.ndarray, active0: Optional[np.ndarray] = None):
    """Initial dense state (numpy; moved to device by the runner)."""
    n, k, m = cfg.n, cfg.k, sched.m_total
    if active0 is None:
        active0 = adj0 >= 0
    return dict(
        arr=np.full((n, m), INF, np.int32),
        delivered=np.full((n, m), -1, np.int32),
        adj=adj0.astype(np.int32),
        delay=delay0.astype(np.int32),
        active=active0.astype(bool),
        gate=np.full((n, k), -1, np.int32),       # -1 = safe
        flush=np.full((n, k), INF, np.int32),
        ping=np.full((n, k), -1, np.int32),       # message slot of the ping
    )


def random_instance(seed: int, n: int, k: int, m_app: int, n_adds: int,
                    n_rms: int, rounds: int, max_delay: int = 3,
                    mode: str = "pc", pong_delay: int = 1,
                    always_gate: bool = False):
    """A random connected instance: ring + random extra links, random
    broadcast/churn schedule.  Used by tests and benchmarks."""
    rng = np.random.default_rng(seed)
    cfg = EngineConfig(n=n, k=k, rounds=rounds, mode=mode,
                       pong_delay=pong_delay, always_gate=always_gate)
    adj0 = np.full((n, k), -1, np.int64)
    adj0[:, 0] = (np.arange(n) + 1) % n          # ring: strong connectivity
    for i in range(n):
        extra = rng.choice(n, size=min(k - 1, max(0, n - 1)), replace=False)
        extra = [int(x) for x in extra if x != i][: k - 2]
        for j, q in enumerate(extra):
            adj0[i, 1 + j] = q                   # leave last slot free
    delay0 = rng.integers(1, max_delay + 1, size=(n, k))

    last_event = max(1, rounds - 3 * max_delay - 6)
    bc_round = np.sort(rng.integers(0, last_event, size=m_app)).astype(np.int32)
    bc_origin = rng.integers(0, n, size=m_app).astype(np.int32)

    # distinct add rounds: the tensor engine evaluates all same-round adds
    # against pre-round state, the numpy ref sequentially — keep them apart
    n_adds = min(n_adds, last_event)
    add_round = np.sort(rng.choice(last_event, size=n_adds,
                                   replace=False)).astype(np.int32)
    add_p = rng.integers(0, n, size=n_adds).astype(np.int32)
    add_k = np.full(n_adds, k - 1, np.int32)     # adds target the free slot
    # distinct p per add so slot reuse cannot collide mid-phase
    if n_adds:
        add_p = np.array(rng.choice(n, size=n_adds, replace=n_adds > n),
                         np.int32)
    add_q = ((add_p + 1 + rng.integers(1, max(2, n - 1), size=n_adds)) % n
             ).astype(np.int32)
    add_delay = rng.integers(1, max_delay + 1, size=n_adds).astype(np.int32)

    rm_round = np.sort(rng.integers(0, last_event, size=n_rms)).astype(np.int32)
    rm_p = rng.integers(0, n, size=n_rms).astype(np.int32)
    rm_k = rng.integers(1, max(2, k - 1), size=n_rms).astype(np.int32)  # never the ring

    sched = Schedule(bc_round, bc_origin, add_round, add_p, add_k, add_q,
                     add_delay, rm_round, rm_p, rm_k)
    return cfg, sched, adj0, delay0
