"""The round bodies of the sharded engine, as plain functions on this
rank's row block of the planes.

Partitioning: every per-process plane — ``arr`` / ``delivered``
``(n_loc, W)``, the ``(n_loc, K)`` slot tables, ``crashed`` /
``ever_del`` — holds this rank's rows ``[off, off + n_loc)``; the
schedule, the ``is_app`` column mask and the rounds are the same on
every rank.  Per round three things cross ranks (the JAX package's
``shard/spanner.py`` does the same over its device mesh):

  * **frontier exchange** — per link slot, the ``slot_frontier`` kernel
    builds this rank's contribution plane (``t + delay`` where the row
    forwards this round's deliveries or flushes its gate window, INF
    elsewhere) and the plane, with its global target rows, visits every
    rank around the ring; at each hop the ``ring_apply`` kernel
    scatter-mins the rows the visited rank owns.  int32 min commutes,
    so the result equals the one-device scatter whatever the hop order;
  * **pong query ring** — pong detection reads ``delivered[q, s]`` at
    a gated link's remote target; the ``(n_loc, K)`` query triples
    (target, ping column, answer) ride the ring and come home after
    ``world`` hops with the answer filled in by the target's owner;
  * **sums** — the per-round stats rows are summed over the ranks once
    per segment, as are the per-column retirement aggregates
    (``retire.py``).

Schedule events are owner-local: the driver hands each rank only the
events of its rows, already in local row indices, so phases 1-4 are the
single-device :func:`~repro_torch.core.vecsim.sim.apply_events`.

Two bodies run a segment:

  * :func:`generic_span` — every round of a run with live gating or a
    segment with link additions/removals.  Phase 5 is the
    ``deliver_sweep`` kernel on the local rows.  ``deferred`` (the
    driver's ``scan="on"``) scatters a round's exchange into a fresh
    INF ``pending`` plane that folds into ``arr`` at the next round's
    entry, with a residual fold after the segment (exact: every
    contribution is ``>= t + 1`` and nothing reads ``arr`` in between);
    otherwise the exchange scatters into ``arr`` directly;
  * :func:`fast_span` — a topology-quiescent segment of a run without
    live gating: ``arr``/``delivered`` live in int16 for the segment
    (``INT16_LIMIT`` stands in for INF), the round's delivery frontier
    is bit-packed 8 columns a byte, its stats come from byte popcounts,
    and the packed frontier is all-gathered in ring order and
    OR-combined at each receiver through the per-delay-class inverse
    tables (``mesh.inverse_tables``), deferred like the generic body.

Both write one stats row a round into a device tensor the driver reads
(summed over the ranks) once per segment.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .. import kernels as kx
from ..scenario import INF
from ..sim import apply_events
from .mesh import ShardGroup

__all__ = ["INT16_LIMIT", "resolve_scan", "generic_span", "fast_span",
           "fast_positions"]

# int16 ceiling of the fast body: arrival rounds live in int16 planes
# there, with this value standing in for INF.  The driver selects the
# fast body only when rounds + max_delay stays below it.
INT16_LIMIT = 32767

_INF = int(INF)


def resolve_scan(scan: str) -> str:
    """The sharded engine's ``scan`` knob: ``"auto"`` is ``"on"`` (the
    deferred exchange, the fused retirement reduce and the fast body on
    quiescent segments); ``"off"`` steps every round through the
    generic body with the exchange scattered straight into ``arr``."""
    if scan == "auto":
        return "on"
    if scan in ("on", "off"):
        return scan
    raise ValueError(f"unknown scan mode {scan!r} (the sharded segment "
                     "loop runs scan 'auto', 'on' or 'off')")


def _pong_answers(delivered: torch.Tensor, adj: torch.Tensor,
                  ping: torch.Tensor, group: ShardGroup) -> torch.Tensor:
    """``delivered[adj, ping]`` at the (possibly remote) target of every
    local slot, clipped as the one-device read is: the query ring.  The
    (target, ping column, answer) triples travel as one stacked tensor,
    one shift a hop, and are home after ``world`` hops."""
    n_loc, w = delivered.shape
    qsa = torch.stack([adj.clamp(0, n_loc * group.world - 1),
                       ping.clamp(0, w - 1), torch.full_like(adj, -1)])
    for _hop in range(group.world):
        ql = qsa[0] - group.off
        hit = (ql >= 0) & (ql < n_loc)
        got = delivered[ql.clamp(0, n_loc - 1).long(), qsa[1].long()]
        qsa[2] = torch.where(hit, got, qsa[2])
        if group.world > 1:
            qsa = group.ring_shift(qsa)
    return qsa[2]


def generic_span(st: Dict[str, torch.Tensor], sched, t0: int, t1: int,
                 series: torch.Tensor, *, group: ShardGroup, pc: bool,
                 always_gate: bool, pong_delay: int, gating: bool,
                 deferred: bool) -> None:
    """Advance this rank's rows through rounds ``[t0, t1)`` in place,
    writing each round's (local) stats into row ``t - t0`` of
    ``series``.  ``sched`` gives each round's owned events
    (``events(family, t)``) and the column mask ``is_app``.  ``gating``
    asserts whether the *scenario* adds links (the only source of
    gates)."""
    arr, delivered = st["arr"], st["delivered"]
    adj, delay, active = st["adj"], st["delay"], st["active"]
    gate, flush, ping, crashed = (st["gate"], st["flush"], st["ping"],
                                  st["crashed"])
    is_app = sched.is_app
    gated_pc = pc and gating
    zero = torch.zeros((), dtype=torch.int64, device=arr.device)
    pending = torch.full_like(arr, _INF) if deferred else None
    for i, t in enumerate(range(t0, t1)):
        if deferred and i:
            # the previous round's in-flight exchange lands now, before
            # anything reads arr
            torch.minimum(arr, pending, out=arr)
            pending.fill_(_INF)
        # -- 1-4. owner-local events ------------------------------------ #
        apply_events(st, sched, t, pc=pc, always_gate=always_gate)
        alive = ~crashed[:, None]
        # -- 5. arrivals -> deliveries (local rows) ---------------------- #
        _, napp, nping = kx.deliver_sweep(arr, delivered, crashed, is_app, t)
        # -- 6. pong detection: the query ring --------------------------- #
        if gated_pc:
            ans = _pong_answers(delivered, adj, ping, group)
            fire = ((gate >= 0) & (flush == _INF) & (ping >= 0)
                    & (ans >= 0) & alive)
            flush.masked_fill_(fire, t + pong_delay)
            pongs = fire.sum()
            # a slot flushing this round forwards as safe in the same
            # round: its gate reads as cleared for the forward mask
            flushing = flush == t
            do = flushing & active & alive
            gk_eff = gate.masked_fill(flushing, -1)
        else:
            pongs = zero
            do = torch.zeros_like(active)
            gk_eff = gate
        ok = active & (gk_eff < 0) & (adj >= 0) & alive
        elig = ok.sum(dim=1)
        # -- 7+8. flush + forward: the frontier exchange ----------------- #
        # Each slot's plane lands on the rows this rank owns at hop 0;
        # with several ranks the slots' planes and targets then travel
        # the ring together, one shift of each a hop (the order of the
        # scatter-mins does not matter: min commutes, and no plane reads
        # dest).
        dest = pending if deferred else arr
        flush_sent = zero
        gate_t, delay_t, adj_t = (x.t().contiguous()
                                  for x in (gate, delay, adj))
        do_t, ok_t = do.t().contiguous(), ok.t().contiguous()
        planes = []
        for kk in range(adj.shape[1]):
            # the raw gate: slot_frontier's flush window starts there
            vals, win_cnt = kx.slot_frontier(delivered, gate_t[kk],
                                             delay_t[kk], do_t[kk], ok_t[kk],
                                             is_app, t, gated_pc)
            flush_sent = flush_sent + win_cnt
            kx.ring_apply(dest, vals, adj_t[kk], group.off)
            if group.world > 1:
                planes.append(vals)
        if group.world > 1:
            vals, tgt = torch.stack(planes), adj_t
            for _hop in range(1, group.world):
                vals, tgt = group.ring_shift(vals), group.ring_shift(tgt)
                for kk in range(adj.shape[1]):
                    kx.ring_apply(dest, vals[kk], tgt[kk], group.off)
        if gated_pc:
            gate.masked_fill_(flushing, -1)
            ping.masked_fill_(flushing, -1)
            flush.masked_fill_(flushing, _INF)
        series[i] = torch.stack([napp.sum(), (napp * elig).sum(),
                                 (nping * elig).sum(), flush_sent, pongs,
                                 (gate >= 0).sum()])
    if deferred:
        # residual fold: the last round's in-flight exchange
        torch.minimum(arr, pending, out=arr)


def fast_positions(tabs: Sequence[torch.Tensor], group: ShardGroup,
                   n_loc: int) -> List[torch.Tensor]:
    """Receiver-side gather positions into the ring-ordered all-gathered
    frontier, one ``(B, n_loc)`` int64 tensor a delay class: ring hop
    ``j`` brings the block of rank ``(rank - j) % world``, so global
    source row ``s = blk * n_loc + r`` sits at ``((rank - blk) % world)
    * n_loc + r``; "no source" maps to the appended zero row
    ``n_glob``."""
    n_glob = n_loc * group.world
    out = []
    for tab in tabs:
        ip = tab.to(torch.int64)
        blk = ip // n_loc
        pos = ((group.rank - blk) % group.world) * n_loc + (ip - blk * n_loc)
        out.append(torch.where(ip >= n_glob, n_glob, pos).t().contiguous())
    return out


def fast_span(st: Dict[str, torch.Tensor], sched, t0: int, t1: int,
              series: torch.Tensor, *, group: ShardGroup,
              classes: Sequence[Tuple[int, torch.Tensor]],
              ia_pack: torch.Tensor) -> None:
    """The fast body over rounds ``[t0, t1)``: same in-place contract as
    :func:`generic_span` for a segment with no link additions or
    removals in a run without live gating (crashes and broadcasts are
    fine).  ``classes`` is ``(delay, positions)`` per delay class
    (:func:`fast_positions`); ``ia_pack`` the packed ``is_app`` mask."""
    arr, delivered = st["arr"], st["delivered"]
    crashed = st["crashed"]
    n_loc, w = arr.shape
    wp = -(-max(w, 1) // 8)
    arr16 = torch.where(arr >= _INF, INT16_LIMIT, arr).to(torch.int16)
    del16 = delivered.to(torch.int16)
    # eligible links a row: static over the segment except for crashes,
    # which zero the row
    linkcnt = (st["active"] & (st["adj"] >= 0)).sum(dim=1)
    gated = (st["gate"] >= 0).sum()
    zero = torch.zeros((), dtype=torch.int64, device=arr.device)
    zero_row = torch.zeros((1, wp), dtype=torch.uint8, device=arr.device)

    def fold(arr16, pend, tprev):
        # the deferred packed frontier: contributions gathered in round
        # tprev arrive with value tprev + delay
        for (dl, _), pb in zip(classes, pend):
            hit = kx.unpack_columns(pb, w)
            arr16 = torch.where(hit, arr16.clamp(max=tprev + dl), arr16)
        return arr16

    pend: List[torch.Tensor] = []
    tprev = 0
    for i, t in enumerate(range(t0, t1)):
        arr16 = fold(arr16, pend, tprev)
        ev = sched.events("cr", t)
        if ev is not None:
            crashed[ev[0].long()] = True
        ev = sched.events("bc", t)
        if ev is not None:
            o, s = ev[0].long(), ev[1].long()
            cur = del16[o, s]
            del16[o, s] = torch.where(crashed[o], cur, cur.clamp(min=t))
        newly = (arr16 == t) & (del16 < 0) & ~crashed[:, None]
        del16.masked_fill_(newly, t)
        g = kx.pack_columns(del16 == t)
        rowsum = kx.popcount_bytes(g).sum(dim=1, dtype=torch.int64)
        napp = kx.popcount_bytes(g & ia_pack[None, :]).sum(
            dim=1, dtype=torch.int64)
        elig = linkcnt.masked_fill(crashed, 0)
        series[i] = torch.stack([napp.sum(), (napp * elig).sum(),
                                 ((rowsum - napp) * elig).sum(), zero, zero,
                                 gated])
        # all-gather the packed frontier around the ring, plus the
        # all-zero "no source" row
        blocks = [g]
        for _hop in range(group.world - 1):
            blocks.append(group.ring_shift(blocks[-1]))
        gg = torch.cat(blocks + [zero_row])
        pend = []
        for _, pos in classes:
            acc = gg.index_select(0, pos[0])
            for col in range(1, pos.shape[0]):
                acc |= gg.index_select(0, pos[col])
            pend.append(acc)
        tprev = t
    arr16 = fold(arr16, pend, tprev)
    arr.copy_(torch.where(arr16 >= INT16_LIMIT, _INF, arr16.to(torch.int32)))
    delivered.copy_(del16)
