"""The plain reference of PC-broadcast over a changing overlay: what the
engines must report for a run with link additions and removals, worked
out from the overlay and the schedules alone.

It states Algorithm 2 of arXiv:1805.05201 (the lockstep round of
``repro_torch/core/vecsim/sim.py``'s module docstring, phases 1-8) over
a time-varying set of links, rule by rule:

* **Rounds.**  In round ``T`` the links change first (removals, then
  additions), then broadcasts happen, then copies arriving at ``T`` are
  delivered, then pongs are seen, then every process sends what it
  delivered at ``T``.  A copy sent over a link of delay ``d`` at ``T``
  arrives at ``T + d``; a process delivers a message in the round its
  first copy arrives (the origin in its broadcast round), once.
* **A removal** (``rm_*``; ``sim.py:279-286``) ends a link at the
  start of its round: it carries nothing sent from that round on, while
  copies already sent over it still arrive.  A ``VecScenario`` never
  removes the slot of an addition, so a removal never meets a gate
  (checked here).
* **An addition** of ``p -> q`` at round ``g`` is gated (Algorithm 2's
  ``open``; ``sim.py:287-310``) when ``p`` has another safe link (an
  active link with no open gate, ``sim.py:300``: ``active & gate < 0``
  counts the new one, and a gate flushing in round ``g`` is still
  open) and ``p`` has delivered an app message in a round before ``g``
  (the delivered-something rule, ``always_gate`` false,
  ``sim.py:302-305``).  This reference asserts the second condition
  instead of deciding it: it checks that every adding process
  delivered an app message before its addition, which the benchmark's
  traffic guarantees.  An addition that does not gate is an ordinary
  link from round ``g`` on.
* **The ping** of a gated addition is a message of its own, delivered
  by ``p`` at ``g``.  Like every message it floods: a process sends it,
  in the round it delivers it, over its **safe** links of that round,
  which are its active links with no open gate, a link whose gate
  flushes in that round included (``fwd_ok``, ``sim.py:368-371``).  A
  ping is never buffered.
* **The pong** fires in the first round in which the link's target
  ``q`` has delivered the ping (phase 6, ``sim.py:323-331``); the link
  flushes at ``f = that round + pong_delay`` (``sim.py:362``).  The
  gate is open over rounds ``[g, f)``.
* **An app message** delivered by ``p`` at ``T`` goes out over each
  active link of ``p``: at ``T`` over a safe one; over a link whose
  gate is open at ``T``, at its flush round ``f`` (phase 7:
  ``kernels/ref.py:87-88`` re-sends the app columns delivered in
  ``[gate, f)``), arriving at ``f + d``.  Each such re-send is one
  ``flush_sent`` of round ``f``.
* **The series** of a round: app deliveries; ``sent_app`` and
  ``sent_ping``, each delivery times the number of safe links of its
  process in that round (``sim.py:383-386``); ``flush_sent``; pongs
  fired; gates open at the round's end (``g <= T < f``: a gate clears
  after its flush, ``sim.py:374-376``).  ``NetStats`` and the first
  receipts (cells with a copy arrived before the end) follow as in
  :mod:`.outcome`.
* **The window** (``stream.py:526-540``, at the end of every segment of
  ``seg_len`` rounds, whose last round is ``T``): an app column retires
  once every process has delivered it and no process ``p`` that
  delivered it at ``d`` has a gate open at ``T`` with ``g <= d``
  (``retire_reduce``'s ``blocked``); so at the end of the first segment
  whose last round is at least the later of its full-delivery round
  and the flush round of every gate it met.  A ping column retires once
  everyone delivered it and its gate has flushed (a live ``ping`` slot
  references it), and the ping column of an addition that did not gate
  at the end of its own segment (nobody delivers it).  Columns activate
  at the start of the segment of their round; the most columns held
  (counted at each activation, ``stream.py:318``) is
  :func:`.serve.batch_columns` of those activation and retirement
  rounds.

The work is split two ways:

(a) :func:`gate_pass`, one round-by-round pass over the ping messages
    only (the gates' rounds depend on nothing else): every gate's flush
    round, the ping series and receipts, and the links' timeline
    (:class:`Links`);
(b) :func:`flood_block`, the app messages in blocks, each as a flood
    over that timeline in round order from its broadcast round, a
    process sending only in the round it delivers.

Plain PyTorch and numpy, on the card where the harness runs it and on
the CPU in the tests.  It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .outcome import NB, SERIES_FIELDS, netstats
from .serve import batch_columns

__all__ = ["Links", "GatePass", "gate_pass", "flood_block",
           "churn_outcome"]

_INF = 2 ** 30
_ADD = ("add_round", "add_p", "add_k", "add_q", "add_delay")
_RM = ("rm_round", "rm_p", "rm_k")


def _buckets(v: torch.Tensor) -> torch.Tensor:
    """:func:`.outcome.bucket_index` on a tensor."""
    extra = torch.zeros_like(v)
    for k in range(5, 20):
        extra += (v >= (1 << k)).to(v.dtype)
    return torch.where(v < 16, v.clamp(0, 15),
                       (16 + extra).clamp(max=NB - 1))


def _events(inp: dict):
    add = [np.asarray(inp.get(f, np.zeros(0)), np.int64) for f in _ADD]
    rm = [np.asarray(inp.get(f, np.zeros(0)), np.int64) for f in _RM]
    for group in (add, rm):
        order = np.argsort(group[0], kind="stable")
        group[:] = [a[order] for a in group]
    return add, rm


@dataclass
class Links:
    """The out-links over time.  Slots that never change keep their
    initial link; each slot some addition or removal touches (``dyn``,
    flat ``p * K + k``) has a row a round: its target, delay and the
    round a delivery of that round leaves over it (that round if the
    link is safe, the flush round if a gate holds it, ``_INF`` if the
    slot is empty)."""

    n: int
    k: int
    tgt0: torch.Tensor       # (N, K) int64, -1 empty
    dly0: torch.Tensor       # (N, K) int64
    dyn: torch.Tensor        # (D,) int64
    d_tgt: torch.Tensor      # (R, D) int64
    d_dly: torch.Tensor      # (R, D) int64
    d_send: torch.Tensor     # (R, D) int64

    def at(self, t: int):
        """``(tgt, send, dly)``, each ``(N, K)`` int64, of round ``t``."""
        tgt, dly = self.tgt0.clone(), self.dly0.clone()
        send = torch.where(self.tgt0 >= 0, t, _INF)
        if len(self.dyn):
            for plane, rows in ((tgt, self.d_tgt), (dly, self.d_dly),
                                (send, self.d_send)):
                plane.view(-1)[self.dyn] = rows[t]
        return tgt, send, dly


@dataclass
class GatePass:
    gated: np.ndarray        # (E,) bool: the addition gated
    flush: np.ndarray        # (E,) int64 flush round, _INF if none
    ping_done: np.ndarray    # (E,) int64 round everyone had the ping, -1
    series: np.ndarray       # (R, 6) int64: sent_ping, pongs, gated only
    first_receipts: int      # ping cells with a copy arrived in the run
    links: Links


def gate_pass(inp: dict, pong_delay: int, device="cpu") -> GatePass:
    """Pass (a): the pings and gates, round by round."""
    n, k, rounds = int(inp["n"]), int(inp["k"]), int(inp["rounds"])
    dev = torch.device(device)
    (a_r, a_p, a_k, a_q, a_d), (r_r, r_p, r_k) = _events(inp)
    a_slot, r_slot = a_p * k + a_k, r_p * k + r_k
    if set(a_slot.tolist()) & set(r_slot.tolist()):
        raise ValueError("a removal of an addition's slot")
    if len(set(a_slot.tolist())) != len(a_slot):
        raise ValueError("a slot added twice")
    e_n = len(a_r)
    tgt = torch.as_tensor(np.asarray(inp["adj0"], np.int64), device=dev)
    dly = torch.as_tensor(np.asarray(inp["delay0"], np.int64), device=dev)
    tgt0, dly0 = tgt.clone(), dly.clone()
    on = tgt >= 0
    slot_t = torch.as_tensor(a_slot, device=dev)
    q_t = torch.as_tensor(a_q, device=dev)
    p_t = torch.as_tensor(a_p, device=dev)
    gate = torch.full((e_n,), -1, dtype=torch.int64, device=dev)
    flush = torch.full((e_n,), _INF, dtype=torch.int64, device=dev)
    pdel = torch.full((n, e_n), -1, dtype=torch.int32, device=dev)
    parr = torch.full((n, e_n), _INF, dtype=torch.int32, device=dev)
    cols = torch.arange(e_n, device=dev)
    series = torch.zeros((rounds, len(SERIES_FIELDS)), dtype=torch.int64,
                         device=dev)
    held_slot = torch.zeros(n * k, dtype=torch.int64, device=dev)
    for t in range(rounds):
        i0, i1 = np.searchsorted(r_r, [t, t + 1])
        if i1 > i0:
            on.view(-1)[torch.as_tensor(r_slot[i0:i1], device=dev)] = False
        e0, e1 = (int(x) for x in np.searchsorted(a_r, [t, t + 1]))
        if e1 > e0:
            es = cols[e0:e1]
            s = slot_t[es]
            tgt.view(-1)[s] = q_t[es]
            dly.view(-1)[s] = torch.as_tensor(a_d[e0:e1], device=dev)
            on.view(-1)[s] = True
            # safe for the gating rule: no gate opened before t and not
            # yet cleared (one flushing at t is still set)
            open_ = (gate >= 0) & (gate < t) & (flush >= t)
            held_slot.zero_().scatter_reduce_(0, slot_t, open_.long(),
                                              "amax")
            safe = on & ~held_slot.view(n, k).bool()
            other = safe.sum(dim=1)[p_t[es]] >= 2
            gate[es] = torch.where(other, t, -1)
            pdel[p_t[es], es] = torch.where(other, t, -1).to(torch.int32)
        newly = (parr == t) & (pdel < 0)
        pdel.masked_fill_(newly, t)
        waiting = (gate >= 0) & (flush == _INF)
        fire = waiting & (pdel[q_t, cols] >= 0)
        flush = torch.where(fire, t + pong_delay, flush)
        held = (gate >= 0) & (gate <= t) & (flush > t)
        held_slot.zero_().scatter_reduce_(0, slot_t, held.long(), "amax")
        safe = on & (tgt >= 0) & ~held_slot.view(n, k).bool()
        elig = safe.sum(dim=1)
        now = pdel == t
        series[t, 2] = (now.sum(dim=1) * elig).sum()
        series[t, 4] = fire.sum()
        series[t, 5] = held.sum()
        qi, ei = torch.nonzero(now, as_tuple=True)
        for kk in range(k):
            ok = safe[qi, kk]
            lin = tgt[qi, kk][ok] * e_n + ei[ok]
            parr.view(-1).scatter_reduce_(
                0, lin, (t + dly[qi, kk][ok]).to(torch.int32), "amin")
    got = pdel >= 0
    ping_done = torch.where(got.all(dim=0), pdel.amax(dim=0),
                            torch.full_like(pdel[0], -1))
    gated = (gate >= 0).cpu().numpy()
    flush_np = flush.cpu().numpy()
    links = _links(n, k, rounds, tgt0, dly0, (a_r, a_slot, a_q, a_d),
                   (r_r, r_slot), gated, flush_np, dev)
    return GatePass(gated=gated, flush=flush_np,
                    ping_done=ping_done.cpu().numpy().astype(np.int64),
                    series=series.cpu().numpy(),
                    first_receipts=int((parr < rounds).sum()), links=links)


def _links(n, k, rounds, tgt0, dly0, adds, rms, gated, flush, dev) -> Links:
    a_r, a_slot, a_q, a_d = adds
    r_r, r_slot = rms
    dyn = np.unique(np.concatenate([a_slot, r_slot]))
    col = {int(s): j for j, s in enumerate(dyn)}
    d_tgt = np.full((rounds, len(dyn)), -1, np.int64)
    d_dly = np.ones((rounds, len(dyn)), np.int64)
    d_send = np.full((rounds, len(dyn)), _INF, np.int64)
    t0 = tgt0.view(-1).cpu().numpy()
    l0 = dly0.view(-1).cpu().numpy()
    # per slot: (round, kind, target, delay, flush) of its changes
    changes: Dict[int, list] = {int(s): [] for s in dyn}
    for e in range(len(a_r)):
        f = int(flush[e]) if gated[e] else -1
        changes[int(a_slot[e])].append((int(a_r[e]), 1, int(a_q[e]),
                                        int(a_d[e]), f))
    for i in range(len(r_r)):
        changes[int(r_slot[i])].append((int(r_r[i]), 0, -1, 1, -1))
    every = np.arange(rounds, dtype=np.int64)
    for s, evs in changes.items():
        j = col[s]
        evs.sort(key=lambda e: (e[0], e[1]))
        # (start, target, delay, flush round or -1) of each link held
        spans = [(0, int(t0[s]), int(l0[s]), -1)] + [
            (e[0], e[2], e[3], e[4]) for e in evs]
        for i, (start, q, d, f) in enumerate(spans):
            end = spans[i + 1][0] if i + 1 < len(spans) else rounds
            if q < 0 or end <= start:
                continue
            d_tgt[start:end, j] = q
            d_dly[start:end, j] = d
            d_send[start:end, j] = every[start:end]
            if f >= 0:                      # gated over [start, f)
                d_send[start:min(f, end), j] = f
    as_t = (lambda a: torch.as_tensor(a, device=dev))
    return Links(n=n, k=k, tgt0=tgt0, dly0=dly0, dyn=as_t(dyn.astype(
        np.int64)), d_tgt=as_t(d_tgt), d_dly=as_t(d_dly),
        d_send=as_t(d_send))


@dataclass
class Block:
    """What pass (b) gives for a block of app messages."""

    cnt: np.ndarray          # (B,) deliveries
    dsum: np.ndarray         # (B,) sum of delivery rounds
    done: np.ndarray         # (B,) full-delivery round, -1 if never
    hold: np.ndarray         # (B,) latest flush round of a gate met, -1
    first: np.ndarray        # (N,) earliest delivery of the block
    series: np.ndarray       # (R, 6): deliveries, sent_app, flush_sent
    first_receipts: int
    hist: np.ndarray         # (NB,)


def flood_block(links: Links, rnd: np.ndarray, org: np.ndarray,
                rounds: int, gate_p: torch.Tensor, gate_g: torch.Tensor,
                gate_f: torch.Tensor) -> Block:
    """Pass (b) for broadcasts ``(rnd, org)``, round-sorted: each
    process sends a message only in the round it delivers it, over the
    links of that round; ``gate_*`` are the gates (process, gate round,
    flush round) on the card."""
    n, dev, b = links.n, links.tgt0.device, len(rnd)
    rnd_t = torch.as_tensor(np.asarray(rnd, np.int64), device=dev)
    org_t = torch.as_tensor(np.asarray(org, np.int64), device=dev)
    dl = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    ar = torch.full((b, n), _INF, dtype=torch.int32, device=dev)
    dl[torch.arange(b, device=dev), org_t] = rnd_t.to(torch.int32)
    series = torch.zeros((rounds, len(SERIES_FIELDS)), dtype=torch.int64,
                         device=dev)
    last = int(rnd[-1])
    t = int(rnd[0])
    while t < rounds and t <= last:
        dl = torch.where((ar == t) & (dl < 0), t, dl)
        bi, pi = torch.nonzero(dl == t, as_tuple=True)
        tgt, send, dly = links.at(t)
        s, q = send[pi], tgt[pi]
        safe = s == t
        series[t, 0] = len(bi)
        series[t, 1] = safe.sum()
        later = (s > t) & (s < _INF)
        series[:, 3] += torch.bincount(s[later & (s < rounds)],
                                       minlength=rounds)[:rounds]
        # a send matters only to a process that has not delivered the
        # message yet, or to its origin (whose first receipt counts)
        go = (safe | later) & (q >= 0)
        lin = bi[:, None] * n + q.clamp(min=0)
        go &= (dl.view(-1)[lin] < 0) | (q == org_t[bi][:, None])
        if go.any():
            val = (s + dly[pi])[go]
            ar.view(-1).scatter_reduce_(0, lin[go], val.to(torch.int32),
                                        "amin")
            last = max(last, int(val.max()))
        t += 1
    got = dl >= 0
    cnt = got.sum(dim=1)
    dsum = torch.where(got, dl, 0).sum(dim=1, dtype=torch.int64)
    done = torch.where(cnt == n, dl.amax(dim=1), -1)
    dg = dl[:, gate_p].to(torch.int64)
    met = (dg >= gate_g[None, :]) & (dg < gate_f[None, :])
    hold = torch.where(met, gate_f[None, :], -1).amax(dim=1) \
        if len(gate_p) else torch.full((b,), -1, device=dev)
    lat = (dl.to(torch.int64) - rnd_t[:, None])[got]
    hist = torch.bincount(_buckets(lat), minlength=NB)
    first = torch.where(got, dl, _INF).amin(dim=0)
    return Block(cnt=cnt.cpu().numpy().astype(np.int64),
                 dsum=dsum.cpu().numpy(),
                 done=done.cpu().numpy().astype(np.int64),
                 hold=hold.cpu().numpy().astype(np.int64),
                 first=first.cpu().numpy().astype(np.int64),
                 series=series.cpu().numpy(),
                 first_receipts=int((ar < rounds).sum()),
                 hist=hist.cpu().numpy().astype(np.int64))


def churn_outcome(inp: dict, seg_len: int, pong_delay: int, device="cpu",
                  block: int = 2048) -> Dict:
    """The reference's answers for a run of ``inp`` (the overlay, the
    broadcasts and the link schedules) under PC-broadcast with no crash,
    and the most columns a window of ``seg_len``-round segments holds;
    the app messages go through (b) ``block`` at a time."""
    if len(inp.get("crash_round", ())):
        raise ValueError("the reference has no crashes")
    n, rounds = int(inp["n"]), int(inp["rounds"])
    dev = torch.device(device)
    rnd = np.asarray(inp["bcast_round"], np.int64)
    org = np.asarray(inp["bcast_origin"], np.int64)
    m = len(rnd)
    gp = gate_pass(inp, pong_delay, dev)
    (a_r, a_p, _, _, _), _ = _events(inp)

    cnt = np.zeros(m, np.int64)
    dsum = np.zeros(m, np.int64)
    done = np.full(m, -1, np.int64)
    hold = np.full(m, -1, np.int64)
    series = gp.series.copy()
    hist = np.zeros(NB, np.int64)
    first_receipts = gp.first_receipts
    first = np.full(n, _INF, np.int64)
    g_sel = np.nonzero(gp.gated)[0]
    gate_p = torch.as_tensor(a_p[g_sel], device=dev)
    gate_g = torch.as_tensor(a_r[g_sel], device=dev)
    gate_f = torch.as_tensor(gp.flush[g_sel], device=dev)
    for i0 in range(0, m, block):
        sel = slice(i0, i0 + block)
        blk = flood_block(gp.links, rnd[sel], org[sel], rounds, gate_p,
                          gate_g, gate_f)
        cnt[sel], dsum[sel] = blk.cnt, blk.dsum
        done[sel], hold[sel] = blk.done, blk.hold
        series[:, [0, 1, 3]] += blk.series[:, [0, 1, 3]]
        hist += blk.hist
        first_receipts += blk.first_receipts
        first = np.minimum(first, blk.first)
    if len(a_r) and not (first[a_p] < a_r).all():
        raise ValueError("an adding process had delivered no app message "
                         "before its addition: the reference assumes it")
    # the window: activation and retirement rounds of every column
    never = (done < 0) | (hold >= _INF)
    app_done = np.where(never, -1, np.maximum(done, hold))
    ping_done = np.where(
        gp.gated, np.where((gp.ping_done < 0) | (gp.flush >= _INF), -1,
                           np.maximum(gp.ping_done, gp.flush)), a_r)
    peak = batch_columns(np.concatenate([rnd, a_r]),
                         np.concatenate([app_done, ping_done]), rounds,
                         seg_len)
    lat_cnt = int(cnt.sum())
    return dict(deliv_count=cnt, deliv_round_sum=dsum,
                bcast_done=rnd < rounds, series=series,
                first_receipts=first_receipts,
                stats=netstats(series, first_receipts),
                lat_sum=int(dsum.sum() - (cnt * rnd).sum()),
                lat_cnt=lat_cnt, latency_hist=hist, peak_live=peak,
                gates=int(gp.gated.sum()))
