"""Preplanned large-N scenarios for the vectorized lockstep simulator.

A :class:`VecScenario` is an initial ``(N, K)`` out-link table plus
integer-round schedules for broadcasts, link churn and crashes; the
port's engines (``vecsim.sim.execute_vec`` and
``vecsim.stream.execute_windowed``) execute it in lockstep rounds.

This module is the port's own copy of the JAX package's
``repro.core.vecsim.scenario``: the builders are kept line for line, so
the same seed gives the same arrays in both packages, and
:func:`scenario_from_arrays` carries a scenario built anywhere else into
the port from its plain numpy fields.

Builder invariants (asserted by :meth:`VecScenario.validate`):

  * slot 0 holds a directed ring that is never removed, so the overlay
    stays strongly connected and flooding reaches everyone;
  * a process's active out-targets are distinct at all times, so a vec
    slot removal maps to exactly one ``Network.disconnect``;
  * at most one broadcast per (origin, round), so per-origin message
    counters are identical across engines;
  * same-round link additions touch distinct processes (the lockstep
    engine evaluates all of a round's additions against the same
    pre-round state).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np

__all__ = ["INF", "VecScenario", "ring_topology", "kregular_topology",
           "smallworld_topology", "settle_rounds", "diameter_bound",
           "poisson_traffic", "bursty_traffic", "TrafficModel",
           "static_scenario", "link_add_scenario", "churn_scenario",
           "crash_scenario", "partition_heal_scenario",
           "churn_wave_scenario", "sustained_scenario",
           "scenario_from_arrays"]

INF = np.int32(2 ** 30)


def _i32(a) -> np.ndarray:
    return np.asarray(a, np.int32)


def _empty() -> np.ndarray:
    return np.zeros((0,), np.int32)


@dataclass(frozen=True, eq=False)
class VecScenario:
    """A fully preplanned run: topology + integer-round schedules."""

    n: int                       # processes
    k: int                       # out-link slots per process
    rounds: int                  # lockstep rounds to simulate
    adj0: np.ndarray             # (N, K) initial out-targets, -1 = empty
    delay0: np.ndarray           # (N, K) per-link delay in rounds (>= 1)
    bcast_round: np.ndarray      # (M,) sorted broadcast rounds
    bcast_origin: np.ndarray     # (M,)
    add_round: np.ndarray = field(default_factory=_empty)   # (E,)
    add_p: np.ndarray = field(default_factory=_empty)
    add_k: np.ndarray = field(default_factory=_empty)
    add_q: np.ndarray = field(default_factory=_empty)
    add_delay: np.ndarray = field(default_factory=_empty)
    rm_round: np.ndarray = field(default_factory=_empty)    # (R,)
    rm_p: np.ndarray = field(default_factory=_empty)
    rm_k: np.ndarray = field(default_factory=_empty)
    crash_round: np.ndarray = field(default_factory=_empty)  # (C,)
    crash_pid: np.ndarray = field(default_factory=_empty)
    mode: str = "pc"             # "pc" (link-safety gating) | "r" (none)
    pong_delay: int = 1          # rounds for the pong rho to return
    always_gate: bool = False    # paper-faithful unconditional gating

    @property
    def m_app(self) -> int:
        return len(self.bcast_round)

    @property
    def n_adds(self) -> int:
        return len(self.add_round)

    @property
    def m_total(self) -> int:
        """App slots + one ping slot per link addition."""
        return self.m_app + self.n_adds

    def msg_counters(self) -> np.ndarray:
        """Per-origin sequential counter of each app slot (1-based), i.e.
        the ``AppMsg.counter`` the exact engine assigns to that broadcast."""
        counters = np.zeros(self.m_app, np.int32)
        seen: dict = {}
        for i, o in enumerate(self.bcast_origin):
            o = int(o)
            seen[o] = seen.get(o, 0) + 1
            counters[i] = seen[o]
        return counters

    def validate(self) -> "VecScenario":
        """Check every builder invariant, raising :class:`ValueError`
        with an informative message (never a bare ``AssertionError`` —
        the checks must survive ``python -O`` and read well from
        ``repro_torch.api`` spec errors)."""
        def fail(msg: str):
            raise ValueError(f"invalid VecScenario: {msg}")

        if self.mode not in ("pc", "r"):
            fail(f"mode={self.mode!r} must be 'pc' or 'r'")
        if self.n < 1 or self.k < 1:
            fail(f"n={self.n}, k={self.k} must be >= 1")
        for name, a in (("adj0", self.adj0), ("delay0", self.delay0)):
            if a.shape != (self.n, self.k):
                fail(f"{name} shape {a.shape} != (n={self.n}, k={self.k})")
        if (self.adj0 >= self.n).any() or (self.adj0 < -1).any():
            fail("adj0 targets must be -1 (empty) or process ids in "
                 f"[0, {self.n})")
        if ((self.delay0 < 1) & (self.adj0 >= 0)).any():
            fail("populated adj0 slots need delay0 >= 1 (a same-round "
                 "hop has no exact-engine equivalent)")
        # ragged schedules: every schedule is a parallel array group
        groups = {
            "bcast": (self.bcast_round, self.bcast_origin),
            "add": (self.add_round, self.add_p, self.add_k, self.add_q,
                    self.add_delay),
            "rm": (self.rm_round, self.rm_p, self.rm_k),
            "crash": (self.crash_round, self.crash_pid),
        }
        for gname, arrays in groups.items():
            lens = {len(a) for a in arrays}
            if len(lens) > 1:
                fail(f"ragged {gname} schedule: column lengths "
                     f"{sorted(len(a) for a in arrays)} differ")
        if len(self.bcast_round) and (np.diff(self.bcast_round) < 0).any():
            fail("bcast_round is not sorted")
        for gname, ids, hi in (("bcast_origin", self.bcast_origin, self.n),
                               ("add_p", self.add_p, self.n),
                               ("add_q", self.add_q, self.n),
                               ("rm_p", self.rm_p, self.n),
                               ("crash_pid", self.crash_pid, self.n),
                               ("add_k", self.add_k, self.k),
                               ("rm_k", self.rm_k, self.k)):
            if len(ids) and ((ids < 0).any() or (ids >= hi).any()):
                fail(f"{gname} out of range: values must lie in [0, {hi})"
                     f" (got min={int(ids.min())}, max={int(ids.max())})")
        if len(self.add_delay) and (self.add_delay < 1).any():
            fail("add_delay entries must be >= 1")
        pairs = set(zip(self.bcast_origin.tolist(), self.bcast_round.tolist()))
        if len(pairs) != self.m_app:
            fail("duplicate (origin, round) broadcast: per-origin message "
                 "counters would diverge between the engines")
        # same-round adds must touch distinct processes (lockstep batching)
        for t in np.unique(self.add_round):
            ps = self.add_p[self.add_round == t]
            if len(set(ps.tolist())) != len(ps):
                fail(f"two link additions at round {int(t)} share a "
                     "process (same-round adds are batched against the "
                     "same pre-round state)")
        # distinct out-targets per process, so every (p, slot) maps to one
        # (p, q) link in the exact-engine replay
        for p in range(self.n):
            tgt = [int(q) for q in self.adj0[p] if q >= 0]
            if len(set(tgt)) != len(tgt):
                fail(f"bad slot table: duplicate out-target at process {p}"
                     " (a vec slot removal must map to exactly one link)")
            if p in tgt:
                fail(f"bad slot table: self-link at process {p}")
        add_pk = list(zip(self.add_p.tolist(), self.add_k.tolist()))
        if len(set(add_pk)) != len(add_pk):
            fail("slot added twice (reuse of a slot mid-run is not "
                 "modeled)")
        for e in range(self.n_adds):
            p, q = int(self.add_p[e]), int(self.add_q[e])
            if q == p:
                fail(f"addition {e} is a self-link at process {p}")
            init = {int(x) for x in self.adj0[p] if x >= 0}
            if q in init:
                fail(f"addition {e} duplicates an initial target of {p}")
        # removals never touch the connectivity ring (slot 0) or overwrite
        # a scheduled addition's slot
        if len(self.rm_k):
            if (self.rm_k == 0).any():
                fail("a removal targets slot 0 — the never-removed "
                     "connectivity ring")
            add_slots = set(add_pk)
            rm_slots = set(zip(self.rm_p.tolist(), self.rm_k.tolist()))
            both = add_slots & rm_slots
            if both:
                fail(f"removal races an addition on slot(s) "
                     f"{sorted(both)}")
        return self


def settle_rounds(n: int, k: int, max_delay: int, pong_delay: int = 1,
                  diam: Optional[int] = None) -> int:
    """Rounds needed after the last scheduled event for a broadcast to
    flood the overlay and all ping phases to resolve.

    Without ``diam`` this uses the expander heuristic (flooding diameter
    ~ log_{k-1} N hops, each up to ``max_delay``) — fine for ring+random
    and k-regular overlays, NOT sound for low-beta small-world lattices
    whose diameter is Θ(n/k).  Builders that know the actual slot table
    pass ``diam=diameter_bound(adj0)``, which makes the returned window
    a *sound* delivery bound on static overlays: every broadcast
    delivers everywhere within ``settle_rounds(...)`` rounds of its
    broadcast round (property-tested in ``tests/test_vecsim_fuzz.py``)."""
    if diam is None:
        diam = math.ceil(math.log(max(n, 2)) / math.log(max(k - 1, 2))) + 3
    return (diam + 2) * max_delay + 2 * pong_delay + 6


def diameter_bound(adj: np.ndarray) -> int:
    """Sound upper bound on the directed hop diameter of a slot-table
    graph: ``ecc_out(0) + ecc_in(0)`` (every u→w path via node 0 is at
    most that long, and the true diameter never exceeds it).  Two
    vectorized BFS sweeps, O(E) per level."""
    n, k = adj.shape
    mask = adj >= 0
    src = np.repeat(np.arange(n), k)[mask.ravel()]
    dst = adj.ravel()[mask.ravel()].astype(np.int64)

    def ecc(forward: bool) -> int:
        seen = np.zeros(n, bool)
        frontier = np.zeros(n, bool)
        seen[0] = frontier[0] = True
        hops = 0
        while True:
            if forward:
                cand = dst[frontier[src]]
            else:
                cand = src[frontier[dst]]
            frontier = np.zeros(n, bool)
            fresh = cand[~seen[cand]]
            if not len(fresh):
                break
            seen[fresh] = frontier[fresh] = True
            hops += 1
        if not seen.all():
            raise ValueError("slot table is not strongly connected "
                             f"({int((~seen).sum())} unreachable "
                             f"{'from' if forward else 'to'} process 0)")
        return hops

    return ecc(True) + ecc(False)


def ring_topology(seed: int, n: int, k: int, max_delay: int = 3,
                  free_slots: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Directed ring on slot 0 plus random distinct extra out-links on
    slots ``1 .. k-1-free_slots``; the last ``free_slots`` slots stay
    empty for scheduled additions.  Targets are distinct per process so
    every (p, slot) maps to a unique (p, q) link."""
    rng = np.random.default_rng(seed)
    adj0 = np.full((n, k), -1, np.int32)
    adj0[:, 0] = (np.arange(n) + 1) % n
    n_extra = max(0, k - 1 - free_slots)
    for p in range(n):
        used = {p, int(adj0[p, 0])}
        j = 1
        while j <= n_extra and len(used) < n:
            q = int(rng.integers(0, n))
            if q not in used:
                adj0[p, j] = q
                used.add(q)
                j += 1
    delay0 = rng.integers(1, max_delay + 1, size=(n, k)).astype(np.int32)
    return adj0, delay0


def _spread_broadcasts(rng, n: int, m_app: int, lo: int, hi: int):
    """Sorted broadcast schedule over [lo, hi) with unique (origin, round)."""
    seen = set()
    rounds, origins = [], []
    while len(rounds) < m_app:
        t, o = int(rng.integers(lo, hi)), int(rng.integers(0, n))
        if (o, t) not in seen:
            seen.add((o, t))
            rounds.append(t)
            origins.append(o)
    order = np.argsort(np.asarray(rounds), kind="stable")
    return (_i32(np.asarray(rounds)[order]), _i32(np.asarray(origins)[order]))


def static_scenario(seed: int, n: int, k: int = 4, m_app: int = 8,
                    max_delay: int = 3, mode: str = "pc",
                    pong_delay: int = 1, topology: str = "ring",
                    beta: float = 0.2) -> VecScenario:
    """Broadcast-only run on a static overlay (``topology`` picks the
    builder: ring+random, k-regular, or small-world with ``beta``)."""
    adj0, delay0 = _build_topology(topology, seed, n, k, max_delay,
                                   free_slots=1, beta=beta)
    rng = np.random.default_rng(seed + 1)
    window = max(2 * m_app, 8)
    bc_round, bc_origin = _spread_broadcasts(rng, n, m_app, 0, window)
    rounds = window + settle_rounds(n, k, max_delay, pong_delay,
                                    diam=diameter_bound(adj0))
    return VecScenario(n=n, k=k, rounds=rounds, adj0=adj0, delay0=delay0,
                       bcast_round=bc_round, bcast_origin=bc_origin,
                       mode=mode, pong_delay=pong_delay).validate()


def _plan_adds(rng, n: int, k: int, adj0: np.ndarray, n_adds: int,
               lo: int, hi: int, max_delay: int):
    """Schedule link additions on the free slot ``k-1`` of distinct
    processes, each targeting a process not currently in p's out-view."""
    hi = max(hi, lo + 1)
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


def link_add_scenario(seed: int, n: int, k: int = 4, m_app: int = 10,
                      n_adds: Optional[int] = None, max_delay: int = 3,
                      pong_delay: int = 1, topology: str = "ring",
                      beta: float = 0.2) -> VecScenario:
    """Static bootstrap, early broadcasts, then a batch of link additions
    that race with later broadcasts — the Fig. 3 shortcut situation that
    PC-broadcast's ping gating exists to make safe.  Additions happen
    after every process has delivered the early traffic, so the gating
    condition (Algorithm 2 with the delivered-something fast-path)
    engages identically in both engines."""
    n_adds = n_adds if n_adds is not None else max(2, n // 8)
    adj0, delay0 = _build_topology(topology, seed, n, k, max_delay,
                                   free_slots=1, beta=beta)
    rng = np.random.default_rng(seed + 2)
    settle = settle_rounds(n, k, max_delay, pong_delay)
    early = max(2, m_app // 3)
    bc_round_a, bc_origin_a = _spread_broadcasts(rng, n, early, 0, 2 * early)
    t_add_lo = 2 * early + settle          # early traffic fully delivered
    t_add_hi = t_add_lo + max(4, n_adds)
    adds = _plan_adds(rng, n, k, adj0, n_adds, t_add_lo, t_add_hi, max_delay)
    bc_round_b, bc_origin_b = _spread_broadcasts(
        rng, n, m_app - early, t_add_lo, t_add_hi + 4)
    bc_round = np.concatenate([bc_round_a, bc_round_b])
    bc_origin = np.concatenate([bc_origin_a, bc_origin_b])
    rounds = int(t_add_hi) + 4 + settle
    return VecScenario(n=n, k=k, rounds=rounds, adj0=adj0, delay0=delay0,
                       bcast_round=_i32(bc_round), bcast_origin=_i32(bc_origin),
                       add_round=adds[0], add_p=adds[1], add_k=adds[2],
                       add_q=adds[3], add_delay=adds[4],
                       pong_delay=pong_delay).validate()


def churn_scenario(seed: int, n: int, k: int = 5, m_app: int = 12,
                   n_adds: Optional[int] = None, n_rms: Optional[int] = None,
                   max_delay: int = 3, pong_delay: int = 1,
                   churn_window: Optional[int] = None,
                   topology: str = "ring", beta: float = 0.2) -> VecScenario:
    """Broadcasts interleaved with batched link additions *and* removals
    (the ring is never removed, so the overlay stays connected).

    ``churn_window`` — rounds the add/remove batch is spread over; adds
    land on distinct processes, so packing several into one round is
    valid for the lockstep batching rule."""
    n_adds = n_adds if n_adds is not None else max(2, n // 8)
    n_rms = n_rms if n_rms is not None else max(2, n // 8)
    adj0, delay0 = _build_topology(topology, seed, n, k, max_delay,
                                   free_slots=1, beta=beta)
    rng = np.random.default_rng(seed + 3)
    settle = settle_rounds(n, k, max_delay, pong_delay)
    early = max(2, m_app // 3)
    bc_round_a, bc_origin_a = _spread_broadcasts(rng, n, early, 0, 2 * early)
    lo = 2 * early + settle
    hi = lo + (churn_window if churn_window is not None
               else max(6, n_adds, n_rms))
    adds = _plan_adds(rng, n, k, adj0, n_adds, lo, hi, max_delay)
    # removals: random non-ring, non-add slots that are populated initially
    rm_round, rm_p, rm_k = [], [], []
    for _ in range(n_rms):
        p = int(rng.integers(0, n))
        kk = int(rng.integers(1, max(2, k - 1)))
        if adj0[p, kk] >= 0:
            rm_round.append(int(rng.integers(lo, hi)))
            rm_p.append(p)
            rm_k.append(kk)
    if rm_round:
        order = np.argsort(np.asarray(rm_round), kind="stable")
        rm = tuple(_i32(np.asarray(a)[order]) for a in (rm_round, rm_p, rm_k))
    else:
        rm = (_empty(), _empty(), _empty())
    bc_round_b, bc_origin_b = _spread_broadcasts(rng, n, m_app - early,
                                                 lo, hi + 4)
    bc_round = np.concatenate([bc_round_a, bc_round_b])
    bc_origin = np.concatenate([bc_origin_a, bc_origin_b])
    rounds = int(hi) + 4 + settle
    return VecScenario(n=n, k=k, rounds=rounds, adj0=adj0, delay0=delay0,
                       bcast_round=_i32(bc_round), bcast_origin=_i32(bc_origin),
                       add_round=adds[0], add_p=adds[1], add_k=adds[2],
                       add_q=adds[3], add_delay=adds[4],
                       rm_round=rm[0], rm_p=rm[1], rm_k=rm[2],
                       pong_delay=pong_delay).validate()


def crash_scenario(seed: int, n: int, k: int = 6, m_app: int = 10,
                   n_crashes: int = 2, max_delay: int = 2,
                   pong_delay: int = 1, topology: str = "ring",
                   beta: float = 0.2) -> VecScenario:
    """Silent crashes (Fig. 5b) mid-broadcast on a well-connected overlay
    (k large enough that the correct subgraph almost surely stays
    connected).  Crashed processes freeze; correct ones keep delivering."""
    base = static_scenario(seed, n, k=k, m_app=m_app, max_delay=max_delay,
                           pong_delay=pong_delay, topology=topology,
                           beta=beta)
    rng = np.random.default_rng(seed + 4)
    mid = int(base.bcast_round[m_app // 2])
    pids = rng.choice(n, size=n_crashes, replace=False)
    # crashed processes never broadcast afterwards: drop their later slots
    keep = ~(np.isin(base.bcast_origin, pids) & (base.bcast_round >= mid))
    return replace(base,
                   bcast_round=base.bcast_round[keep],
                   bcast_origin=base.bcast_origin[keep],
                   crash_round=_i32(np.full(n_crashes, mid)),
                   crash_pid=_i32(pids)).validate()


# --------------------------------------------------------------------- #
# Topology builders beyond ring+random
# --------------------------------------------------------------------- #
def _perm_avoiding(rng, n: int, forbidden: np.ndarray) -> np.ndarray:
    """Random permutation of ``range(n)`` with ``perm[p] != p`` and
    ``perm[p]`` not in ``forbidden[p]`` (an ``(n, j)`` column stack of
    already-used targets).  Repairs conflicts by reshuffling the
    conflicted positions among themselves, which converges quickly while
    the forbidden sets stay small relative to ``n``."""
    perm = rng.permutation(n).astype(np.int64)
    me = np.arange(n)
    for it in range(1000):
        bad = perm == me
        for c in range(forbidden.shape[1]):
            bad |= perm == forbidden[:, c]
        idx = np.nonzero(bad)[0]
        if not len(idx):
            return perm
        if len(idx) == 1 or it % 7 == 6:
            # a lone conflict (or a cycling set) needs fresh material:
            # swap each conflicted position with a random other one
            others = rng.integers(0, n, size=len(idx))
            for i, j in zip(idx, others):
                perm[i], perm[j] = perm[j], perm[i]
        else:
            perm[idx] = perm[idx[rng.permutation(len(idx))]]
    raise RuntimeError("could not build a conflict-free permutation "
                       f"(n={n}, {forbidden.shape[1]} forbidden/row)")


def kregular_topology(seed: int, n: int, k: int, max_delay: int = 3,
                      free_slots: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Random k-regular digraph: slot 0 is the directed ring (a cyclic
    permutation, kept for the never-removed connectivity invariant) and
    each further populated slot is an independent random permutation, so
    every process has equal out- AND in-degree — the paper's uniform
    peer-sampling ideal, without ring+random's in-degree skew."""
    assert n >= k + 2, "need n >= k + 2 distinct targets per process"
    rng = np.random.default_rng(seed)
    adj0 = np.full((n, k), -1, np.int64)
    adj0[:, 0] = (np.arange(n) + 1) % n
    n_extra = max(0, k - 1 - free_slots)
    for j in range(1, n_extra + 1):
        adj0[:, j] = _perm_avoiding(rng, n, adj0[:, :j])
    delay0 = rng.integers(1, max_delay + 1, size=(n, k)).astype(np.int32)
    return adj0.astype(np.int32), delay0


def smallworld_topology(seed: int, n: int, k: int, beta: float = 0.2,
                        max_delay: int = 3, free_slots: int = 1
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Watts-Strogatz-style overlay: a directed ring lattice (slot ``j``
    points ``j+1`` positions ahead) whose non-ring slots are rewired to a
    uniform random target with probability ``beta``.  ``beta=0`` is a
    pure lattice (long paths), ``beta=1`` approaches ring+random; small
    ``beta`` gives the clustered/short-diameter regime in between."""
    rng = np.random.default_rng(seed)
    adj0 = np.full((n, k), -1, np.int64)
    n_used = max(1, k - free_slots)
    assert n > n_used + 1, "lattice needs n > k - free_slots + 1"
    for j in range(n_used):
        adj0[:, j] = (np.arange(n) + j + 1) % n
    for j in range(1, n_used):            # slot 0 ring is never rewired
        for p in np.nonzero(rng.random(n) < beta)[0]:
            p = int(p)
            used = {p} | {int(q) for q in adj0[p] if q >= 0}
            if len(used) >= n:
                continue
            while True:
                q = int(rng.integers(0, n))
                if q not in used:
                    break
            adj0[p, j] = q
    delay0 = rng.integers(1, max_delay + 1, size=(n, k)).astype(np.int32)
    return adj0.astype(np.int32), delay0


# --------------------------------------------------------------------- #
# Traffic schedules: sustained load instead of a fixed broadcast batch
# --------------------------------------------------------------------- #
def _per_round_origins(rng, n: int, counts: np.ndarray, t0: int):
    rounds, origins = [], []
    for off, c in enumerate(counts):
        c = int(min(c, n))
        if c <= 0:
            continue
        rounds.extend([t0 + off] * c)
        origins.extend(rng.choice(n, size=c, replace=False).tolist())
    return _i32(rounds), _i32(origins)


def poisson_traffic(seed: int, n: int, rate: float, t0: int, t1: int,
                    max_messages: Optional[int] = None):
    """Poisson(rate) broadcasts per round over ``[t0, t1)``; origins are
    drawn without replacement per round, so the (origin, round) pairs
    are unique as the lockstep batching rule requires.  Truncates to
    ``max_messages`` if given."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rate, size=max(0, t1 - t0))
    bc_round, bc_origin = _per_round_origins(rng, n, counts, t0)
    if max_messages is not None:
        bc_round, bc_origin = bc_round[:max_messages], bc_origin[:max_messages]
    return bc_round, bc_origin


def bursty_traffic(seed: int, n: int, rate_hi: float, rate_lo: float,
                   period: int, duty: float, t0: int, t1: int,
                   max_messages: Optional[int] = None):
    """On/off traffic: rounds in the first ``duty`` fraction of each
    ``period`` draw Poisson(rate_hi) broadcasts, the rest Poisson(rate_lo)
    — the heavy-tailed load pattern large deployments actually see."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t0, t1)
    hot = (ts % max(1, period)) < duty * period
    counts = rng.poisson(np.where(hot, rate_hi, rate_lo))
    bc_round, bc_origin = _per_round_origins(rng, n, counts, t0)
    if max_messages is not None:
        bc_round, bc_origin = bc_round[:max_messages], bc_origin[:max_messages]
    return bc_round, bc_origin


def _ring_entry(seed, n, k, max_delay, free_slots, beta):
    """directed ring on slot 0 plus random extra out-links"""
    return ring_topology(seed, n, k, max_delay, free_slots)


def _kregular_entry(seed, n, k, max_delay, free_slots, beta):
    """random k-regular digraph (equal out- AND in-degree)"""
    return kregular_topology(seed, n, k, max_delay, free_slots)


def _smallworld_entry(seed, n, k, max_delay, free_slots, beta):
    """Watts-Strogatz ring lattice rewired with probability beta"""
    return smallworld_topology(seed, n, k, beta=beta, max_delay=max_delay,
                               free_slots=free_slots)


#: Topology dispatch table, keyed by the ``topology=`` builder argument.
#: Every entry has the uniform signature
#: ``(seed, n, k, max_delay, free_slots, beta) -> (adj0, delay0)``.
#: ``repro.api.TOPOLOGIES`` is a live view of this dict, so a kind
#: registered there is immediately buildable by every scenario builder.
_TOPOLOGIES = {"ring": _ring_entry, "kregular": _kregular_entry,
               "smallworld": _smallworld_entry}


def _build_topology(topology: str, seed: int, n: int, k: int,
                    max_delay: int, free_slots: int, beta: float):
    try:
        builder = _TOPOLOGIES[topology]
    except KeyError:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"choose from {sorted(_TOPOLOGIES)}") from None
    return builder(seed, n, k, max_delay, free_slots, beta)


@dataclass(frozen=True)
class TrafficModel:
    """A sustained-traffic generator, dispatchable by name.

    ``build(seed, n, t0, t1, max_messages, params)`` returns the sorted
    ``(bcast_round, bcast_origin)`` pair (unique (origin, round), per
    the lockstep batching rule); ``mean_rate(params)`` is the expected
    broadcasts per round, used to size the schedule span.  ``params``
    carries the RunSpec traffic knobs: rate, rate_lo, period, duty.
    ``repro.api.TRAFFIC`` is a live view of the ``_TRAFFIC`` table, so
    a model registered there is immediately usable by
    :func:`sustained_scenario`."""

    build: object
    mean_rate: object
    description: str = ""        # one line for the CLI discovery surface


_TRAFFIC = {
    "poisson": TrafficModel(
        build=lambda seed, n, t0, t1, mm, p:
            poisson_traffic(seed, n, p["rate"], t0, t1, mm),
        mean_rate=lambda p: p["rate"],
        description="Poisson(rate) broadcasts per round, sustained"),
    "bursty": TrafficModel(
        build=lambda seed, n, t0, t1, mm, p:
            bursty_traffic(seed, n, p["rate"], p["rate_lo"], p["period"],
                           p["duty"], t0, t1, mm),
        mean_rate=lambda p: (p["duty"] * p["rate"]
                             + (1 - p["duty"]) * p["rate_lo"]),
        description="on/off load: Poisson(rate) for a duty fraction of "
        "each period, Poisson(rate_lo) otherwise"),
}


# --------------------------------------------------------------------- #
# Partition / heal
# --------------------------------------------------------------------- #
def partition_heal_scenario(seed: int, n: int, k: int = 5, m_app: int = 12,
                            n_cross: Optional[int] = None,
                            n_heal: Optional[int] = None,
                            n_bridge: int = 1,
                            max_delay: int = 2, pong_delay: int = 1,
                            traffic_during_partition: bool = False
                            ) -> VecScenario:
    """Two halves, each internally ringed on slot 0, joined by cross
    links on slot ``k-2``.  The partition removes all but ``n_bridge``
    cross links per direction in one round; after a quiet interval,
    fresh cross links are added on the free slot ``k-1`` (the heal) and
    race the tail of the traffic, so the healed links re-enter through
    the Algorithm 2 ping phase exactly like any other addition.

    The surviving bridge makes this a *brownout* rather than a total
    partition, and deliberately so: pings travel over safe links only,
    so after a total partition a healed link's ping could never reach
    its target — the gate would hang forever in both engines and nothing
    would ever heal.  The thin bridge keeps the ping phase functional
    (and Algorithm 2 exercised end-to-end) while cross-half capacity
    collapses; traffic broadcast during the brownout (opt-in) squeezes
    through the bridge at much higher latency."""
    assert k >= 4 and n >= 8
    assert n_bridge >= 1, "a total partition cannot re-gate (see docstring)"
    half = n // 2
    rng = np.random.default_rng(seed)
    n_cross = n_cross if n_cross is not None else max(2, n // 8)
    n_cross = max(n_cross, n_bridge + 1)
    n_heal = n_heal if n_heal is not None else max(2, n // 8)

    adj0 = np.full((n, k), -1, np.int64)
    sides = (np.arange(half), np.arange(half, n))
    for side in sides:
        m = len(side)
        adj0[side, 0] = side[(np.arange(m) + 1) % m]       # intra-half ring
        for p in side:
            p = int(p)
            used = {p, int(adj0[p, 0])}
            for j in range(1, k - 2):
                if len(used) >= m:
                    break
                while True:
                    q = int(side[rng.integers(0, m)])
                    if q not in used:
                        break
                adj0[p, j] = q
                used.add(q)
    # cross links, slot k-2; the first n_bridge per *direction* survive
    # the partition as the brownout bridge (a direction can contribute
    # fewer than n_cross links when n_cross exceeds the half size, so
    # survivors are tracked per direction, not by modulo)
    cross_p, cross_q, sever = [], [], []
    for a, b in ((sides[0], sides[1]), (sides[1], sides[0])):
        ps = a[rng.permutation(len(a))[:n_cross]]
        qs = b[rng.integers(0, len(b), size=len(ps))]
        assert len(ps) > n_bridge, \
            "half too small to keep a bridge and still partition"
        cross_p.extend(int(x) for x in ps)
        cross_q.extend(int(x) for x in qs)
        sever.extend(int(x) for x in ps[n_bridge:])
    adj0[cross_p, k - 2] = cross_q
    delay0 = rng.integers(1, max_delay + 1, size=(n, k)).astype(np.int32)

    settle = settle_rounds(n, k, max_delay, pong_delay)
    m1 = max(2, m_app // 3)
    m2 = max(1, m_app // 4) if traffic_during_partition else 0
    m3 = m_app - m1 - m2
    bc_r1, bc_o1 = _spread_broadcasts(rng, n, m1, 0, 2 * m1)
    t_part = 2 * m1 + settle
    rm_round = _i32(np.full(len(sever), t_part))
    rm_p = _i32(sever)
    rm_k = _i32(np.full(len(sever), k - 2))
    if m2:
        bc_r2, bc_o2 = _spread_broadcasts(rng, n, m2, t_part + 2,
                                          t_part + 2 + 2 * m2)
    t_heal = t_part + (2 * m2 + 2 if m2 else 0) + settle
    # heal: distinct processes, fresh cross targets on the free slot k-1
    heal_p_pool = np.concatenate([sides[0][rng.permutation(half)[:n_heal]],
                                  sides[1][rng.permutation(n - half)[:n_heal]]])
    add_round, add_p, add_k, add_q, add_delay = [], [], [], [], []
    for p in heal_p_pool:
        p = int(p)
        other = sides[1] if p < half else sides[0]
        used = {p} | {int(q) for q in adj0[p] if q >= 0}
        while True:
            q = int(other[rng.integers(0, len(other))])
            if q not in used:
                break
        add_round.append(t_heal + len(add_round) % 4)
        add_p.append(p)
        add_k.append(k - 1)
        add_q.append(q)
        add_delay.append(int(rng.integers(1, max_delay + 1)))
    order = np.argsort(np.asarray(add_round), kind="stable")
    adds = tuple(_i32(np.asarray(a)[order]) for a in
                 (add_round, add_p, add_k, add_q, add_delay))
    bc_r3, bc_o3 = _spread_broadcasts(rng, n, m3, t_heal, t_heal + 4 + m3)
    parts_r = [bc_r1] + ([bc_r2] if m2 else []) + [bc_r3]
    parts_o = [bc_o1] + ([bc_o2] if m2 else []) + [bc_o3]
    bc_round = _i32(np.concatenate(parts_r))
    bc_origin = _i32(np.concatenate(parts_o))
    rounds = int(t_heal) + 4 + m3 + settle
    return VecScenario(n=n, k=k, rounds=rounds,
                       adj0=adj0.astype(np.int32), delay0=delay0,
                       bcast_round=bc_round, bcast_origin=bc_origin,
                       add_round=adds[0], add_p=adds[1], add_k=adds[2],
                       add_q=adds[3], add_delay=adds[4],
                       rm_round=rm_round, rm_p=rm_p, rm_k=rm_k,
                       pong_delay=pong_delay).validate()


# --------------------------------------------------------------------- #
# Churn waves
# --------------------------------------------------------------------- #
def churn_wave_scenario(seed: int, n: int, k: int = 6, m_app: int = 18,
                        waves: int = 3, adds_per_wave: Optional[int] = None,
                        rms_per_wave: Optional[int] = None,
                        wave_gap: Optional[int] = None, max_delay: int = 2,
                        pong_delay: int = 1, topology: str = "ring",
                        beta: float = 0.2) -> VecScenario:
    """Churn arriving in periodic waves — each wave batches link
    additions (on distinct processes drawn from a shared pool, so no
    slot is reused) and removals, with traffic flowing throughout.  The
    dynamic-membership pattern of diurnal or flash-crowd systems."""
    adds_per_wave = adds_per_wave if adds_per_wave is not None \
        else max(2, n // (8 * waves))
    rms_per_wave = rms_per_wave if rms_per_wave is not None \
        else max(2, n // (8 * waves))
    adj0, delay0 = _build_topology(topology, seed, n, k, max_delay,
                                   free_slots=1, beta=beta)
    rng = np.random.default_rng(seed + 5)
    settle = settle_rounds(n, k, max_delay, pong_delay)
    wave_gap = wave_gap if wave_gap is not None else settle // 2 + 4
    early = max(2, m_app // (waves + 1))
    bc_round, bc_origin = _spread_broadcasts(rng, n, early, 0, 2 * early)
    bc_round, bc_origin = [bc_round], [bc_origin]
    lo = 2 * early + settle

    pool = rng.permutation(n)          # distinct add-processes across ALL waves
    pool_at = 0
    add_round, add_p, add_k, add_q, add_delay = [], [], [], [], []
    rm_round, rm_p, rm_k = [], [], []
    rm_seen = set()
    m_left = m_app - early
    for wv in range(waves):
        w_lo = lo + wv * wave_gap
        w_hi = w_lo + max(3, adds_per_wave)
        for _ in range(adds_per_wave):
            if pool_at >= n:
                break
            p = int(pool[pool_at])
            pool_at += 1
            used = {p} | {int(q) for q in adj0[p] if q >= 0}
            if len(used) >= n:
                continue
            while True:
                q = int(rng.integers(0, n))
                if q not in used:
                    break
            add_round.append(int(rng.integers(w_lo, w_hi)))
            add_p.append(p)
            add_k.append(k - 1)
            add_q.append(q)
            add_delay.append(int(rng.integers(1, max_delay + 1)))
        for _ in range(rms_per_wave):
            p = int(rng.integers(0, n))
            kk = int(rng.integers(1, max(2, k - 1)))
            if adj0[p, kk] >= 0 and (p, kk) not in rm_seen:
                rm_seen.add((p, kk))
                rm_round.append(int(rng.integers(w_lo, w_hi)))
                rm_p.append(p)
                rm_k.append(kk)
        m_wave = m_left // (waves - wv)
        m_left -= m_wave
        if m_wave:
            r, o = _spread_broadcasts(rng, n, m_wave, w_lo, w_hi + 4)
            bc_round.append(r)
            bc_origin.append(o)
    order = np.argsort(np.asarray(add_round), kind="stable")
    adds = tuple(_i32(np.asarray(a)[order]) for a in
                 (add_round, add_p, add_k, add_q, add_delay))
    if rm_round:
        order = np.argsort(np.asarray(rm_round), kind="stable")
        rms = tuple(_i32(np.asarray(a)[order])
                    for a in (rm_round, rm_p, rm_k))
    else:
        rms = (_empty(), _empty(), _empty())
    bc_all = np.concatenate(bc_round)
    bo_all = np.concatenate(bc_origin)
    order = np.argsort(bc_all, kind="stable")
    rounds = lo + waves * wave_gap + adds_per_wave + 8 + settle
    return VecScenario(n=n, k=k, rounds=rounds, adj0=adj0, delay0=delay0,
                       bcast_round=_i32(bc_all[order]),
                       bcast_origin=_i32(bo_all[order]),
                       add_round=adds[0], add_p=adds[1], add_k=adds[2],
                       add_q=adds[3], add_delay=adds[4],
                       rm_round=rms[0], rm_p=rms[1], rm_k=rms[2],
                       pong_delay=pong_delay).validate()


# --------------------------------------------------------------------- #
# Sustained heavy traffic (the streaming engine's home scenario)
# --------------------------------------------------------------------- #
def sustained_scenario(seed: int, n: int, k: int = 8,
                       rate: float = 4.0, messages: int = 1000,
                       topology: str = "kregular",
                       traffic: str = "poisson", beta: float = 0.2,
                       burst_period: int = 64, burst_duty: float = 0.25,
                       rate_lo: Optional[float] = None,
                       max_delay: int = 1, mode: str = "pc",
                       pong_delay: int = 1) -> VecScenario:
    """Open-ended sustained load: ``messages`` broadcasts at ``rate`` per
    round on a static well-connected overlay.  Built for the streaming
    windowed engine — the monolithic engine would need O(N·messages)
    memory — but emits the same ``VecScenario`` schema as every other
    builder, so small instances still cross-validate on the exact
    engine."""
    free_slots = 0
    adj0, delay0 = _build_topology(topology, seed, n, k, max_delay,
                                   free_slots, beta)
    try:
        model = _TRAFFIC[traffic]
    except KeyError:
        raise ValueError(f"unknown traffic model {traffic!r}; "
                         f"choose from {sorted(_TRAFFIC)}") from None
    if not isinstance(model, TrafficModel):
        raise ValueError(f"traffic {traffic!r} is not a sustained-traffic "
                         "model (it only schedules batch broadcasts)")
    params = dict(rate=rate, rate_lo=rate / 8 if rate_lo is None
                  else rate_lo, period=burst_period, duty=burst_duty)
    # size the span by the *effective* mean rate (bursty spends most
    # rounds at rate_lo), then grow it if the random draw fell short
    eff_rate = model.mean_rate(params)
    span = max(8, int(np.ceil(messages / max(eff_rate, 1e-9) * 1.25)))
    for _ in range(16):
        bc_round, bc_origin = model.build(seed + 1, n, 0, span, messages,
                                          params)
        if len(bc_round) == messages:
            break
        span *= 2
    assert len(bc_round) == messages, \
        f"traffic span too short: {len(bc_round)} < {messages}"
    last = int(bc_round[-1]) if len(bc_round) else 0
    rounds = last + 1 + settle_rounds(n, k, max_delay, pong_delay,
                                      diam=diameter_bound(adj0))
    return VecScenario(n=n, k=k, rounds=rounds, adj0=adj0, delay0=delay0,
                       bcast_round=bc_round, bcast_origin=bc_origin,
                       mode=mode, pong_delay=pong_delay).validate()


# --------------------------------------------------------------------- #
# Scenarios carried in from plain arrays
# --------------------------------------------------------------------- #
_SCALAR_FIELDS = {"n": int, "k": int, "rounds": int, "mode": str,
                  "pong_delay": int, "always_gate": bool}


def scenario_from_arrays(fields: dict) -> VecScenario:
    """Build a validated :class:`VecScenario` from a field-name -> value
    mapping: the ``(N, K)`` tables and schedules as numpy arrays (copied
    to int32), the scalars (``n``, ``k``, ``rounds``, ``mode``,
    ``pong_delay``, ``always_gate``) as plain values.  Missing schedule
    fields are empty, missing scalar options take the dataclass
    defaults; an unknown name raises :class:`ValueError`.

    This is how a scenario built by another implementation (the JAX
    package's builders, a saved run) enters the port unchanged:
    ``scenario_from_arrays({f: getattr(ref, f) for f in names})``."""
    names = set(VecScenario.__dataclass_fields__)
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown VecScenario field(s) {sorted(unknown)}")
    kw = {}
    for name, value in fields.items():
        if name in _SCALAR_FIELDS:
            kw[name] = _SCALAR_FIELDS[name](value)
        else:
            kw[name] = np.array(value, np.int32)
    return VecScenario(**kw).validate()
