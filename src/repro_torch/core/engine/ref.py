"""NumPy oracle for the tensorized engine: identical round semantics,
written as plain loops (the port's copy of the JAX package's
``core/engine/ref.py``).  The tensor engine (``step.py``) and its sharded
runner must match it exactly (tests/test_torch_engine.py)."""

from __future__ import annotations

import numpy as np

from .state import INF, EngineConfig, Schedule, build_state

__all__ = ["run_ref", "analyze"]


def run_ref(cfg: EngineConfig, sched: Schedule, adj0, delay0):
    st = build_state(cfg, sched, adj0, delay0)
    arr, delivered = st["arr"], st["delivered"]
    adj, delay, active = st["adj"], st["delay"], st["active"]
    gate, flush, ping = st["gate"], st["flush"], st["ping"]
    n, k, m_app = cfg.n, cfg.k, sched.m_app

    for t in range(cfg.rounds):
        # 1. removals
        for e in np.nonzero(sched.rm_round == t)[0]:
            p, kk = int(sched.rm_p[e]), int(sched.rm_k[e])
            active[p, kk] = False
            gate[p, kk], flush[p, kk], ping[p, kk] = -1, INF, -1
        # 2. additions (one ping slot each)
        for e in np.nonzero(sched.add_round == t)[0]:
            p, kk, q = int(sched.add_p[e]), int(sched.add_k[e]), int(sched.add_q[e])
            adj[p, kk], delay[p, kk], active[p, kk] = q, int(sched.add_delay[e]), True
            gate[p, kk], flush[p, kk], ping[p, kk] = -1, INF, -1
            if cfg.mode == "pc":
                other_safe = any(active[p, j] and gate[p, j] < 0
                                 for j in range(k) if j != kk)
                has_delivered = bool((delivered[p, :m_app] >= 0).any())
                if other_safe and (cfg.always_gate or has_delivered):
                    slot = m_app + e
                    gate[p, kk], ping[p, kk] = t, slot
                    delivered[p, slot] = t      # own ping: flooded below
        # 3. broadcasts
        for i in np.nonzero(sched.bcast_round == t)[0]:
            o = int(sched.bcast_origin[i])
            if delivered[o, i] < 0:
                delivered[o, i] = t
        # 4. arrivals -> deliveries
        newly = (arr == t) & (delivered < 0)
        delivered[newly] = t
        # 5. pong detection (target delivered the ping; rho returns oob)
        for p in range(n):
            for kk in range(k):
                if gate[p, kk] >= 0 and flush[p, kk] == INF:
                    s, q = ping[p, kk], adj[p, kk]
                    if s >= 0 and delivered[q, s] >= 0:
                        flush[p, kk] = t + cfg.pong_delay
        # 6. flush: buffered app messages ride the now-safe link
        for p in range(n):
            for kk in range(k):
                if flush[p, kk] == t and active[p, kk]:
                    q, g, d = adj[p, kk], gate[p, kk], delay[p, kk]
                    win = ((delivered[p, :m_app] >= g)
                           & (delivered[p, :m_app] < t))
                    for mm in np.nonzero(win)[0]:
                        arr[q, mm] = min(arr[q, mm], t + d)
                    gate[p, kk], flush[p, kk], ping[p, kk] = -1, INF, -1
        # 7. forward everything delivered this round over safe active links
        new_del = delivered == t
        for p in range(n):
            if not new_del[p].any():
                continue
            for kk in range(k):
                if active[p, kk] and gate[p, kk] < 0 and adj[p, kk] >= 0:
                    q, d = adj[p, kk], delay[p, kk]
                    for mm in np.nonzero(new_del[p])[0]:
                        arr[q, mm] = min(arr[q, mm], t + d)
    return delivered


def analyze(delivered: np.ndarray, sched: Schedule):
    """Causal-order analysis of an engine run (app messages only).

    Checks each message against its *direct* causal past (everything its
    broadcaster had delivered strictly before broadcasting); respecting the
    direct past at every process implies full causal order by induction."""
    m_app = sched.m_app
    d_app = delivered[:, :m_app]
    n = delivered.shape[0]
    n_viol = 0
    n_missing = 0
    latencies = []
    for i in range(m_app):
        o, r0 = int(sched.bcast_origin[i]), int(sched.bcast_round[i])
        past = np.nonzero((d_app[o] >= 0) & (d_app[o] < d_app[o, i]))[0]
        past = past[past != i]
        di = d_app[:, i]
        got_i = di >= 0
        if past.size:
            dj = d_app[:, past]
            n_viol += int(((dj > di[:, None]) & got_i[:, None]
                           & (dj >= 0)).sum())
            n_missing += int(((dj < 0) & got_i[:, None]).sum())
        latencies.extend((di[got_i] - r0).tolist())
    frac = float((d_app >= 0).mean())
    mean_lat = float(np.mean(latencies)) if latencies else float("nan")
    return dict(violations=n_viol, missing=n_missing,
                delivered_frac=frac, mean_latency=mean_lat)
