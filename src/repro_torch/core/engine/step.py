"""The tensorized round engine on torch tensors.

The port of the JAX package's ``core/engine/step.py``: the same seven
phases a round, pinned to ``ref.py`` (the numpy oracle) byte for byte.
Where JAX runs the rounds as one ``lax.scan`` over a jitted body, the
port runs them in a Python loop; the schedule is preplanned, so each
round's removals, additions and broadcasts are picked on the host before
the run (:func:`_round_events`).

Scatter-min is ``index_reduce_(..., "amin")`` over the rows that send:
each slot's sending rows (and, in the sharded runner, those whose
target is this rank's) are picked with ``nonzero``, so a scatter moves
only the rows a round forwards from, and rows outside ``[0, N)`` are
dropped, as ``mode="drop"`` drops them in JAX.  Int32 min commutes, so
the order of the scatter does not matter.

The round body reads the senders' state (``delivered`` after phase 4,
the link slots after phase 5): on one device that is the state itself;
in the sharded runner (``sharded.py``) every rank's rows, gathered,
while the receiving ``arr`` rows and the link slots that change stay
this rank's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...backend import resolve_device
from .state import INF, EngineConfig, Schedule, build_state

__all__ = ["run_engine", "make_step", "STATE_ORDER"]

_INF = int(INF)

#: the order of the state tuple (``make_step``'s ``state``)
STATE_ORDER = ("arr", "delivered", "adj", "delay", "active", "gate",
               "flush", "ping")


@dataclass
class _Events:
    """One round's scheduled events whose process row is this rank's:
    local row and slot index tensors (None when there is none)."""
    rm: Optional[tuple] = None     # (p, k)
    add: Optional[tuple] = None    # (p, k, q, delay, ping slot)
    bc: Optional[tuple] = None     # (origin, message slot)


def _round_events(cfg: EngineConfig, sched: Schedule, off: int, n_loc: int,
                  device) -> Dict[int, _Events]:
    """Round -> its events on rows ``[off, off + n_loc)``, as tensors on
    ``device``, built once before the run."""
    def local(rounds, p):
        rounds = np.asarray(rounds, np.int64)
        p = np.asarray(p, np.int64)
        keep = (p >= off) & (p < off + n_loc) & (rounds >= 0) & \
            (rounds < cfg.rounds)
        return {int(t): np.nonzero(keep & (rounds == t))[0]
                for t in np.unique(rounds[keep])}

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    out: Dict[int, _Events] = {}
    for t, e in local(sched.rm_round, sched.rm_p).items():
        out.setdefault(t, _Events()).rm = (dev(sched.rm_p[e] - off),
                                           dev(sched.rm_k[e]))
    for t, e in local(sched.add_round, sched.add_p).items():
        out.setdefault(t, _Events()).add = (
            dev(sched.add_p[e] - off), dev(sched.add_k[e]),
            dev(sched.add_q[e]), dev(sched.add_delay[e]),
            dev(sched.m_app + e))
    for t, e in local(sched.bcast_round, sched.bcast_origin).items():
        out.setdefault(t, _Events()).bc = (
            dev(sched.bcast_origin[e] - off), dev(e))
    return out


def _scatter_min(dest: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                 vals_of: Callable[[torch.Tensor], torch.Tensor],
                 off: int) -> None:
    """In place: ``dest[tgt[p] - off] = min(dest[tgt[p] - off], vals[p])``
    for every ``valid[p]`` whose target row is one of ``dest``'s, the
    values of rows ``p`` given by ``vals_of(p)``; the other rows are
    dropped."""
    tl = tgt.long() - off
    rows = torch.nonzero(valid & (tl >= 0) & (tl < dest.shape[0]))[:, 0]
    if rows.numel():
        dest.index_reduce_(0, tl[rows], vals_of(rows), "amin")


def _links(gather, adj, delay, active, gate, flush):
    """The link slots of every process row: this rank's own on one
    device (``gather`` None), else every rank's, in one gather."""
    if gather is None:
        return adj, delay, active, gate, flush
    packed = torch.stack([adj, delay, active.to(adj.dtype), gate, flush],
                         dim=1)
    adj, delay, active, gate, flush = gather(packed).unbind(dim=1)
    return adj, delay, active.bool(), gate, flush


def make_step(cfg: EngineConfig, sched: Schedule, device=None, off: int = 0,
              n_loc: Optional[int] = None,
              gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """The per-round body ``step(state, t) -> state`` over the state
    tuple (:data:`STATE_ORDER`), updated in place.  ``off``/``n_loc``
    are this rank's first row and row count (the whole axis by default);
    ``gather`` concatenates every rank's rows of a tensor (``sharded.py``;
    None on one device)."""
    dev = resolve_device(device)
    n_loc = cfg.n if n_loc is None else n_loc
    m_app = sched.m_app
    k_slots = cfg.k
    pc = cfg.mode == "pc"
    events = _round_events(cfg, sched, off, n_loc, dev)

    def step(state, t: int):
        arr, delivered, adj, delay, active, gate, flush, ping = state
        ev = events.get(t)

        # -- 1. removals ---------------------------------------------- #
        if ev is not None and ev.rm is not None:
            p, k = ev.rm
            active[p, k] = False
            gate[p, k] = -1
            flush[p, k] = _INF
            ping[p, k] = -1

        # -- 2. additions (one ping slot each) ------------------------ #
        if ev is not None and ev.add is not None:
            p, k, q, d, slot = ev.add
            adj[p, k] = q.to(adj.dtype)
            delay[p, k] = d.to(delay.dtype)
            active[p, k] = True
            if pc:
                safe = active & (gate < 0)
                other = (safe[p].sum(dim=1) - safe[p, k].int()) >= 1
                want = other
                if not cfg.always_gate:
                    want = want & (delivered[p, :m_app] >= 0).any(dim=1)
                gate[p, k] = torch.where(want, t, -1).to(gate.dtype)
                flush[p, k] = _INF
                ping[p, k] = torch.where(want, slot, -1).to(ping.dtype)
                # own ping is "delivered" by p now -> floods from phase 7
                delivered[p, slot] = torch.where(
                    want, t, delivered[p, slot]).to(delivered.dtype)

        # -- 3. broadcasts -------------------------------------------- #
        if ev is not None and ev.bc is not None:
            o, i = ev.bc
            delivered[o, i] = torch.clamp(delivered[o, i], min=t)

        # -- 4. arrivals -> deliveries -------------------------------- #
        delivered.masked_fill_((arr == t) & (delivered < 0), t)

        # the senders' delivered plane: every row
        d_all = delivered if gather is None else gather(delivered)
        n_all, m_tot = d_all.shape

        # -- 5. pong detection (rho returns out of band) -------------- #
        if pc:
            q_ = adj.clamp(0, n_all - 1).long()
            s_ = ping.clamp(0, m_tot - 1).long()
            tgt_del = d_all[q_, s_]
            fire = (gate >= 0) & (flush == _INF) & (ping >= 0) & \
                (tgt_del >= 0)
            flush.masked_fill_(fire, t + cfg.pong_delay)
        s_adj, s_delay, s_active, s_gate, s_flush = _links(
            gather, adj, delay, active, gate, flush)

        # -- 6. flush buffered app messages over now-safe links ------- #
        if pc:
            d_app = d_all[:, :m_app]
            for kk in range(k_slots):
                do = (s_flush[:, kk] == t) & s_active[:, kk]

                def flushed(rows, kk=kk):
                    d = d_app[rows]
                    win = (d >= s_gate[rows, kk, None]) & (d < t)
                    return torch.where(win, (t + s_delay[rows, kk, None]).to(
                        arr.dtype), _INF)
                _scatter_min(arr[:, :m_app], s_adj[:, kk], do, flushed, off)
            cleared = flush == t
            gate.masked_fill_(cleared, -1)
            ping.masked_fill_(cleared, -1)
            flush.masked_fill_(cleared, _INF)
            if gather is not None:
                s_gate = s_gate.masked_fill(s_flush == t, -1)

        # -- 7. forward this round's deliveries over safe active links  #
        new_del = d_all == t
        sends = new_del.any(dim=1)
        for kk in range(k_slots):
            ok = sends & s_active[:, kk] & (s_gate[:, kk] < 0) & \
                (s_adj[:, kk] >= 0)

            def forwarded(rows, kk=kk):
                return torch.where(new_del[rows], (t + s_delay[rows, kk, None])
                                   .to(arr.dtype), _INF)
            _scatter_min(arr, s_adj[:, kk], ok, forwarded, off)
        return state

    return step


def initial_state(cfg: EngineConfig, sched: Schedule, adj0, delay0,
                  device, rows: slice = slice(None)):
    """``build_state``'s planes (rows ``rows``) on ``device``, in
    :data:`STATE_ORDER`."""
    st = build_state(cfg, sched, np.asarray(adj0), np.asarray(delay0))
    return tuple(torch.as_tensor(np.ascontiguousarray(st[k][rows]),
                                 device=device) for k in STATE_ORDER)


def run_engine(cfg: EngineConfig, sched: Schedule, adj0, delay0,
               device=None):
    """Run the tensor engine on ``device`` (the card unless ``"cpu"`` is
    asked for); returns ``delivered`` as numpy (N, M) int32."""
    dev = resolve_device(device)
    state = initial_state(cfg, sched, adj0, delay0, dev)
    step = make_step(cfg, sched, dev)
    for t in range(cfg.rounds):
        state = step(state, t)
    return state[1].cpu().numpy()
