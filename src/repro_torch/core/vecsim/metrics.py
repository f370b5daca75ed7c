"""Fig. 7 metrics and oracle bridges for the port's engine results.

Mirrors ``obs.graphs`` (which walks the exact engine's ``Network``)
over the dense engine state, as host numpy on the snapshot dicts the
engines return (``VecRunResult.snapshot``/``.state``):

  * ``safe_out_mask`` / ``full_out_mask`` — the (N, K) slots the
    protocol disseminates over, and every alive link;
  * ``mean_shortest_path_vec``  — BFS hop counts over the safe-link or
    full adjacency, vectorized frontier expansion;
  * ``unsafe_link_stats_vec``   — gated links / buffered messages per
    process at a state snapshot, same tuple as ``unsafe_link_stats``;
  * ``build_trace``        — reconstructs an event trace compatible with
    ``core.oracle.check_trace`` from the delivery matrix, so the
    happens-before oracle validates engine runs unchanged;
  * ``delivered_multiset`` — the canonical (pid, origin, counter)
    delivery multiset used for byte-level cross-validation;
  * ``vc_overhead_model``  — the analytic vector-clock overhead a
    PC-broadcast run implies (the measured baseline is ``vecsim.vc``).

Within-round delivery order is not modeled by the lockstep engine; the
trace orders same-round deliveries by message slot, which is consistent
with causality because a causal predecessor always occupies an earlier
slot (broadcast schedules are round-sorted and a message cannot depend
on a same-round broadcast of another origin).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import AppMsg
from .scenario import VecScenario

__all__ = ["safe_out_mask", "full_out_mask", "mean_shortest_path_vec",
           "unsafe_link_stats_vec", "build_trace", "delivered_multiset",
           "vc_overhead_model"]


def safe_out_mask(state: Dict[str, np.ndarray]) -> np.ndarray:
    """(N, K) bool: slots the protocol will actually disseminate over —
    active, ungated, populated, endpoints alive (cf. ``obs.graphs.safe_graph``)."""
    crashed = state["crashed"]
    adj = state["adj"]
    tgt_alive = ~crashed[np.clip(adj, 0, len(crashed) - 1)]
    return (state["active"] & (state["gate"] < 0) & (adj >= 0)
            & ~crashed[:, None] & tgt_alive)


def full_out_mask(state: Dict[str, np.ndarray]) -> np.ndarray:
    """(N, K) bool: all alive links regardless of gating."""
    crashed = state["crashed"]
    adj = state["adj"]
    tgt_alive = ~crashed[np.clip(adj, 0, len(crashed) - 1)]
    return state["active"] & (adj >= 0) & ~crashed[:, None] & tgt_alive


def mean_shortest_path_vec(adj: np.ndarray, mask: np.ndarray,
                           sources: Sequence[int],
                           unreachable_penalty: Optional[float] = None,
                           exclude: Optional[np.ndarray] = None) -> float:
    """Mean BFS hops from ``sources`` to every other (alive) process.

    Frontier-expansion BFS over the (N, K) slot table: each hop gathers
    the out-targets of the current frontier and keeps the unvisited ones.
    ``exclude`` marks processes (e.g. crashed) that are neither expanded
    nor counted as destinations."""
    n = adj.shape[0]
    alive = np.ones(n, bool) if exclude is None else ~exclude
    total, count = 0.0, 0
    for s in sources:
        s = int(s)
        if not alive[s]:
            continue
        dist = np.full(n, -1, np.int32)
        dist[s] = 0
        frontier = np.zeros(n, bool)
        frontier[s] = True
        d = 0
        while frontier.any():
            rows = np.nonzero(frontier)[0]
            sub = mask[rows]
            targets = adj[rows][sub]
            frontier = np.zeros(n, bool)
            if targets.size:
                cand = np.unique(targets)
                cand = cand[(dist[cand] < 0) & alive[cand]]
                dist[cand] = d + 1
                frontier[cand] = True
            d += 1
        reach = (dist > 0)
        total += float(dist[reach].sum())
        count += int(reach.sum())
        missed = int((alive & (dist < 0)).sum())
        if unreachable_penalty is not None and missed:
            total += unreachable_penalty * missed
            count += missed
    return total / count if count else float("nan")


def unsafe_link_stats_vec(state: Dict[str, np.ndarray], t: int,
                          m_app: int) -> Tuple[float, float, int]:
    """(mean unsafe links/process, mean buffered msgs/process, max buffer)
    at a state snapshot taken right after round ``t`` — the same tuple as
    ``obs.graphs.unsafe_link_stats``.  A gated slot's buffer holds
    every app message its owner delivered in ``[gate, t]``.

    Works on monolithic snapshots (app messages are the first ``m_app``
    columns) and on windowed-engine snapshots, which carry an ``is_app``
    mask because live buffer columns interleave app and ping slots; the
    windowed buffer retains every flush-relevant column by construction,
    so the stats are identical."""
    gate, delivered, crashed = state["gate"], state["delivered"], state["crashed"]
    alive = ~crashed
    gated = (gate >= 0) & alive[:, None]
    n_alive = max(1, int(alive.sum()))
    if not gated.any():
        return 0.0, 0.0, 0
    if "is_app" in state:
        d_app = delivered[:, state["is_app"]]
    else:
        d_app = delivered[:, :m_app]
    # buffered[p, kk] = #app msgs delivered by p in [gate, t] on that slot
    win = (d_app >= 0) & (d_app <= t)
    buf = ((d_app[:, None, :] >= gate[:, :, None])
           & win[:, None, :]).sum(axis=2)
    buf = np.where(gated, buf, 0)
    return (float(gated.sum() / n_alive),
            float(buf.sum() / n_alive),
            int(buf.max()))


def _app_msgs(scn: VecScenario) -> List[AppMsg]:
    counters = scn.msg_counters()
    return [AppMsg(int(o), int(c))
            for o, c in zip(scn.bcast_origin, counters)]


def build_trace(res) -> List[Tuple[float, str, int, AppMsg]]:
    """Oracle-compatible trace: per round, broadcasts first (the lockstep
    broadcast phase precedes the arrival-delivery phase), then deliveries
    ordered by message slot.  Accepts monolithic and windowed results —
    the latter must have collected the full delivered matrix
    (``collect="full"``)."""
    if res.delivered is None:
        raise ValueError("trace reconstruction needs the full delivered "
                         "matrix; rerun the windowed engine with "
                         "collect='full'")
    scn = res.scenario
    msgs = _app_msgs(scn)
    d_app = res.delivered[:, : scn.m_app]
    events = []
    for i in range(scn.m_app):
        t = int(scn.bcast_round[i])
        o = int(scn.bcast_origin[i])
        # a broadcast happened iff its origin delivered it (an origin that
        # crashed before its scheduled round never broadcast the message)
        if res.delivered[o, i] >= 0:
            events.append(((t, 0, i, -1), "broadcast", o, msgs[i]))
    pids, slots = np.nonzero(d_app >= 0)
    for p, i in zip(pids.tolist(), slots.tolist()):
        t = int(d_app[p, i])
        events.append(((t, 1, i, p), "deliver", p, msgs[i]))
    events.sort(key=lambda ev: ev[0])
    return [(float(key[0]), kind, pid, m) for key, kind, pid, m in events]


def delivered_multiset(res) -> List[Tuple[int, int, int]]:
    """Sorted (pid, origin, counter) triples over all app deliveries."""
    if res.delivered is None:
        raise ValueError("delivered multiset needs the full delivered "
                         "matrix; rerun the windowed engine with "
                         "collect='full'")
    scn = res.scenario
    counters = scn.msg_counters()
    d_app = res.delivered[:, : scn.m_app]
    pids, slots = np.nonzero(d_app >= 0)
    out = [(int(p), int(scn.bcast_origin[i]), int(counters[i]))
           for p, i in zip(pids.tolist(), slots.tolist())]
    out.sort()
    return out


def vc_overhead_model(res) -> Tuple[float, float]:
    """(mean control bytes/message, mean vector comparisons/delivery) a
    vector-clock baseline would have paid on the same causal run.

    This is the *analytic approximation* that predated the measured
    vectorized VC protocol (``vecsim.vc.run_vec_vc``); benchmarks now
    report the measurement and keep this as ``vc_model`` rows for
    contrast (it counts 16 bytes per clock entry where the exact
    engine's ``control_bytes`` charges 8, and weights by delivery
    counts rather than actual sends).

    Derived from the vec delivery matrix rather than simulated: message
    ``i``'s piggybacked clock holds one entry per distinct origin its
    broadcaster had delivered from before broadcasting (plus itself) —
    exactly what ``VCBroadcast`` piggybacks — and every delivery rescans
    that clock once (Table 1's O(N) terms).  DESIGN.md §2.4."""
    if res.delivered is None:
        raise ValueError("the VC overhead model needs the full delivered "
                         "matrix; rerun the windowed engine with "
                         "collect='full'")
    scn = res.scenario
    d_app = res.delivered[:, : scn.m_app]
    origins = scn.bcast_origin
    vc_len = np.zeros(scn.m_app, np.int64)
    for i in range(scn.m_app):
        o, r = int(origins[i]), int(scn.bcast_round[i])
        seen = (d_app[o] >= 0) & (d_app[o] < r)
        vc_len[i] = len({int(origins[j]) for j in np.nonzero(seen)[0]} |
                        {o})
    deliveries = (d_app >= 0).sum(axis=0)
    total_deliv = int(deliveries.sum())
    sent = max(1, res.stats.sent_messages)
    # bytes: id pair + one (pid, counter) pair per clock entry, weighted by
    # how many copies of each message the network actually carried; approx
    # copies proportional to deliveries.
    bytes_per_msg = float(np.average(16 + 16 * vc_len, weights=np.maximum(
        deliveries, 1)))
    comparisons = (float((vc_len * deliveries).sum() / total_deliv)
                   if total_deliv else 0.0)
    return bytes_per_msg, comparisons
