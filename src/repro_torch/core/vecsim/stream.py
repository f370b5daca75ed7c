"""Streaming windowed execution: sustained traffic in O(N·W) memory, with
the live-column planes kept on the card.

The monolithic engine (``sim.execute_vec``) holds dense ``(N, M_total)``
planes, so memory — not the protocol — caps how much traffic a run can
carry.  This engine processes the message axis through a fixed buffer
of ``W`` live *columns* instead, exactly as the JAX package's
``repro.core.vecsim.stream`` does:

  * a message (app broadcast or link-addition ping) is **activated** —
    assigned a free buffer column — just before its scheduled round
    (:class:`ColumnWindow`, host bookkeeping);
  * rounds advance segment by segment through the *same* span runner as
    the monolithic engine (``sim.run_span``);
  * between segments, columns are **retired**: their per-message results
    fold into aggregates and the column is recycled.

Retirement is exact — a column leaves the buffer only when nothing in
the monolithic run could still touch it:

  1. every non-crashed process has delivered it, AND no pending gated
     link could still flush it (some process delivered it at or after
     the link's gate round), for app columns;
  2. ping columns additionally stay while any live ``ping[p, k]`` slot
     references them (pong detection reads their delivery row);
  3. columns that can never become live (their broadcast was skipped by
     a crashed origin, or their link addition did not gate) retire as
     soon as their round has passed.

An optional ``horizon`` force-retires columns older than ``horizon``
rounds, at the (flagged, in ``expired``) cost of dropping whatever late
activity the column still had.

The ``arr``/``delivered`` planes never leave the device.  Per segment
the host reads the segment's stats rows, the ``(N, K)`` gate tables, and
the five ``(W,)`` column reductions of the ``retire_reduce`` kernel;
retiring columns are recorded from those reductions and reset on the
device, and only with ``collect="full"`` is their ``delivered`` slice
copied to the host.

Telemetry (``repro_torch.obs``, threaded in as ``obs=``) hooks in where
the JAX stepper hooks it: the latency histogram of the retiring app
columns is folded by the ``latency_hist`` kernel straight from the live
plane (only its 32 bucket sums reach the host), the flight recorder gets
an ``index_select`` of only the *sampled* retiring columns, and spans
wrap each segment's dispatch and retirement.  On the card
``segment.dispatch`` ends when the last round is enqueued; the wait for
the device lands in ``segment.retire``, whose first read is the
segment's stats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...backend import resolve_device
from ...obs.spans import NULL_RECORDER
from ..types import NetStats
from . import kernels as kx
from .scenario import INF, VecScenario
from .sim import (SERIES_FIELDS, DeviceSchedule, SlotSchedule, host,
                  init_topo_state, run_span, state_to_device, state_to_host,
                  stats_from_series)

__all__ = ["WindowedRunResult", "WindowOverflowError", "ColumnWindow",
           "WindowedStepper", "execute_windowed"]


class WindowOverflowError(RuntimeError):
    """The live-column buffer filled up and nothing could retire.

    ``round`` carries the first round whose due event found no free
    column — with the round-granular horizon sweeps in
    :meth:`ColumnWindow.activate` it is the same round for every
    ``seg_len`` choice.

    The raise happens *before* any column assignment or schedule-cursor
    movement, so the window (and with it the whole engine) is left
    exactly as it was at the segment boundary."""

    def __init__(self, message: str, round: Optional[int] = None):
        super().__init__(message)
        self.round = round


@dataclass
class WindowedRunResult:
    """Result of a streaming windowed run.

    ``delivered`` is the full ``(N, M_total)`` matrix only when the run
    collected it (``collect="full"``); sustained runs keep per-message
    aggregates instead.  ``stats``/``series`` match the monolithic run
    byte for byte whenever no column was horizon-expired."""

    scenario: VecScenario
    window: int
    device: str
    stats: NetStats
    series: np.ndarray              # (rounds, len(SERIES_FIELDS)) int64
    delivered: Optional[np.ndarray]  # (N, M_total) or None (aggregate mode)
    deliv_count: np.ndarray         # (M_total,) deliveries per message
    bcast_done: np.ndarray          # (m_app,) broadcast actually happened
    expired: np.ndarray             # (M_total,) retired by horizon expiry
    state: Dict[str, np.ndarray]    # final topology state + live buffer
    snapshot: Optional[Dict[str, np.ndarray]]
    peak_live: int                  # max live columns ever resident
    lat_sum: int                    # sum of (deliver - broadcast) rounds
    lat_cnt: int                    # delivered (process, app msg) pairs
    # (M_total,) sum of delivery rounds over the processes that
    # delivered each message
    deliv_round_sum: Optional[np.ndarray] = None
    segments: int = 0               # segments run
    sweeps: int = 0                 # retirement sweeps over live columns
    # retirement sweeps (and the final drain) that retired app columns
    app_sweeps: int = 0

    @property
    def m_app(self) -> int:
        return self.scenario.m_app

    @property
    def delivered_app(self) -> Optional[np.ndarray]:
        return (None if self.delivered is None
                else self.delivered[:, : self.m_app])

    def delivered_frac(self) -> float:
        """Fraction of (correct process, app message) pairs delivered.
        Exact when the full matrix was collected; aggregate mode reports
        deliveries over *all* ``N × m_app`` pairs (the two agree on
        crash-free runs)."""
        if self.delivered is not None:
            ok = ~self.state["crashed"]
            d = self.delivered[ok][:, : self.m_app]
            return float((d >= 0).mean()) if d.size else 1.0
        denom = self.scenario.n * self.m_app
        if not denom:
            return 1.0
        return float(self.deliv_count[: self.m_app].sum()) / denom

    def mean_latency(self) -> float:
        """Mean rounds from broadcast to delivery over delivered pairs."""
        return self.lat_sum / self.lat_cnt if self.lat_cnt else float("nan")


class ColumnWindow:
    """Host-side live-column bookkeeping: the round-sorted activation
    streams (broadcasts + link additions), the column -> message
    assignment, the live high-water mark, and the segment-sliced
    slot-space schedules.

    Broadcasts activate from ``bc_round[:m_bc]``: the scenario's whole
    schedule here, a buffer that grows between segments in the live
    serving loop's subclass (``live.window.LiveColumnWindow``).  The
    global message-id space is split at ``m_app_cap``: app message ``i``
    is id ``i``, link-addition ping ``e`` is id ``m_app_cap + e``.

    ``horizon`` mirrors the driver's force-expiry knob: when set,
    :meth:`activate` additionally caps every segment at the earliest
    round a live column comes due for expiry (``birth + horizon + 1``),
    so the boundary retirement sweep lands *exactly* on the expiry
    round, and expiry — and with it overflow timing — does not depend on
    ``seg_len``."""

    def __init__(self, scn: VecScenario, window: int,
                 horizon: Optional[int] = None):
        self.scn = scn
        self.w = int(window)
        self.horizon = None if horizon is None else int(horizon)
        m_app = scn.m_app
        self.bc_round = scn.bcast_round
        self.bc_origin = scn.bcast_origin
        self.m_bc = m_app           # broadcasts scheduled so far
        self.m_app_cap = m_app      # id split: ping e -> m_app_cap + e
        self.next_bc = 0            # first not-yet-activated broadcast
        self.next_add = 0           # first not-yet-activated addition
        self.peak_live = 0

        self.slot_msg = np.full(self.w, -1, np.int64)   # global id, -1 = free
        self.slot_birth = np.zeros(self.w, np.int32)    # activation round
        self.slot_app = np.zeros(self.w, bool)
        self.bc_live_slot = np.full(m_app, -1, np.int32)
        self.add_live_slot = np.full(scn.n_adds, -1, np.int32)

        # Round-sorted copies of the schedules so each segment slices
        # with two binary searches (broadcasts are sorted by
        # construction).  The stable sort keeps same-round order, which
        # the round body is insensitive to anyway.
        self.add_ord = np.argsort(scn.add_round, kind="stable")
        self.add_round_s = scn.add_round[self.add_ord]
        self.add_p_s = scn.add_p[self.add_ord]
        self.add_k_s = scn.add_k[self.add_ord]
        self.add_q_s = scn.add_q[self.add_ord]
        self.add_delay_s = scn.add_delay[self.add_ord]
        rm_ord = np.argsort(scn.rm_round, kind="stable")
        self.rm_round_s = scn.rm_round[rm_ord]
        self.rm_p_s, self.rm_k_s = scn.rm_p[rm_ord], scn.rm_k[rm_ord]
        cr_ord = np.argsort(scn.crash_round, kind="stable")
        self.cr_round_s = scn.crash_round[cr_ord]
        self.cr_pid_s = scn.crash_pid[cr_ord]

    def seg_schedule(self, lo: int, hi: int) -> SlotSchedule:
        b0, b1 = np.searchsorted(self.bc_round[: self.m_bc], [lo, hi])
        a0, a1 = np.searchsorted(self.add_round_s, [lo, hi])
        r0, r1 = np.searchsorted(self.rm_round_s, [lo, hi])
        c0, c1 = np.searchsorted(self.cr_round_s, [lo, hi])
        return SlotSchedule(
            is_app=self.slot_app,
            bc_round=self.bc_round[b0:b1],
            bc_origin=self.bc_origin[b0:b1],
            bc_slot=self.bc_live_slot[b0:b1],
            add_round=self.add_round_s[a0:a1],
            add_p=self.add_p_s[a0:a1], add_k=self.add_k_s[a0:a1],
            add_q=self.add_q_s[a0:a1],
            add_delay=self.add_delay_s[a0:a1],
            add_slot=self.add_live_slot[self.add_ord[a0:a1]],
            rm_round=self.rm_round_s[r0:r1],
            rm_p=self.rm_p_s[r0:r1], rm_k=self.rm_k_s[r0:r1],
            cr_round=self.cr_round_s[c0:c1],
            cr_pid=self.cr_pid_s[c0:c1])

    def _assign(self, free: np.ndarray, nb_a: int, na_a: int) -> None:
        """Bind the next ``nb_a`` broadcasts and ``na_a`` additions to
        the leading free columns, in merged round order (broadcasts
        before additions on round ties, original index order within a
        kind — the stable lexsort keeps the column -> message mapping
        identical run to run)."""
        n_assign = nb_a + na_a
        b0, a0 = self.next_bc, self.next_add
        r_all = np.concatenate([
            self.bc_round[b0: b0 + nb_a],
            self.add_round_s[a0: a0 + na_a]]).astype(np.int64)
        kind = np.zeros(n_assign, np.int8)
        kind[nb_a:] = 1
        order = np.lexsort((kind, r_all))
        col = np.empty(n_assign, np.int64)
        col[order] = free[:n_assign]
        bc_cols, add_cols = col[:nb_a], col[nb_a:]
        bc_ids = np.arange(b0, b0 + nb_a)
        self.slot_msg[bc_cols] = bc_ids
        self.slot_birth[bc_cols] = self.bc_round[b0: b0 + nb_a]
        self.slot_app[bc_cols] = True
        self.bc_live_slot[bc_ids] = bc_cols
        add_idx = self.add_ord[a0: a0 + na_a]
        self.slot_msg[add_cols] = self.m_app_cap + add_idx
        self.slot_birth[add_cols] = self.add_round_s[a0: a0 + na_a]
        self.slot_app[add_cols] = False
        self.add_live_slot[add_idx] = add_cols
        self.next_bc = b0 + nb_a
        self.next_add = a0 + na_a

    def activate(self, t: int, t_end: int) -> int:
        """Assign free columns to events due before ``t_end``; returns
        the (possibly shortened) segment end.  Raises
        :class:`WindowOverflowError` when the buffer is already full at
        ``t`` with an event due — *before* touching any state.  Also
        tracks the live high-water mark, and with a horizon caps the
        segment at the earliest expiry-due round."""
        b_hi = self.next_bc + int(np.searchsorted(
            self.bc_round[self.next_bc: self.m_bc], t_end))
        a_hi = int(np.searchsorted(self.add_round_s, t_end))
        nb, na = b_hi - self.next_bc, a_hi - self.next_add
        if nb or na:
            free = np.nonzero(self.slot_msg < 0)[0]
            kfree = len(free)
            nb_a, na_a = nb, na
            if nb + na > kfree:
                # The merged stream blocks: find the round of the first
                # event that does not fit BEFORE mutating anything, so
                # an overflow raise leaves the window untouched.  The
                # (kfree+1)-th smallest merged (round, kind) key lives
                # within the first kfree+1 events of each stream.
                bs = self.bc_round[
                    self.next_bc: min(b_hi, self.next_bc + kfree + 1)]
                as_ = self.add_round_s[
                    self.next_add: min(a_hi, self.next_add + kfree + 1)]
                keys = np.concatenate([bs.astype(np.int64) * 2,
                                       as_.astype(np.int64) * 2 + 1])
                keys.sort()
                blocked_key = int(keys[kfree])
                blocked_at = blocked_key >> 1
                if blocked_at <= t:
                    raise WindowOverflowError(
                        f"window={self.w} cannot hold the live messages "
                        f"at round {t} "
                        f"({int((self.slot_msg >= 0).sum())} live, "
                        f"next event needs a free column); raise the "
                        f"window or set a horizon", round=t)
                # stop the segment just before the first blocked event
                # and retry after the next retirement sweep
                t_end = blocked_at
                if blocked_key & 1:      # first blocked event is an add
                    nb_a = int(np.searchsorted(bs, blocked_at,
                                               side="right"))
                    na_a = kfree - nb_a
                else:                    # first blocked event: broadcast
                    na_a = int(np.searchsorted(as_, blocked_at,
                                               side="left"))
                    nb_a = kfree - na_a
            if nb_a + na_a:
                self._assign(free, nb_a, na_a)
        live = self.slot_msg >= 0
        if self.horizon is not None and live.any():
            # land the next boundary exactly on the earliest expiry-due
            # round (always > t: anything due at t expired in the sweep
            # that closed the previous segment)
            expiry_due = int(self.slot_birth[live].min()) + self.horizon + 1
            if expiry_due < t_end:
                t_end = expiry_due
        self.peak_live = max(self.peak_live, int(live.sum()))
        return t_end


class WindowedStepper:
    """The windowed engine, one segment per :meth:`advance` call
    (activate -> span -> retire); :meth:`finish` drains the live columns
    and builds the result.  ``cw`` optionally supplies an externally
    built window (the live loop passes its growable subclass); ``obs``
    is the run's :class:`~repro_torch.obs.spans.EngineObs` or None."""

    def __init__(self, scn: VecScenario, window: int, device=None,
                 horizon: Optional[int] = None, seg_len: int = 32,
                 snapshot_round: Optional[int] = None,
                 collect: str = "auto",
                 cw: Optional[ColumnWindow] = None, obs=None):
        self.device = dev = resolve_device(device)
        self.obs = obs
        self.hist = obs is not None and obs.histograms
        self._rec = obs.spans if obs is not None else NULL_RECORDER
        self._sid = {name: self._rec.name(f"segment.{name}")
                     for name in ("dispatch", "retire")}
        # flight recorder: host-side provenance hooks, None when off
        self._flight = getattr(obs, "flight", None)
        self.w = w = int(window)
        if w < 1:
            raise ValueError("window must be >= 1")
        self.seg_len = seg_len = max(1, int(seg_len))
        self.scn = scn
        self.horizon = None if horizon is None else int(horizon)
        self.snapshot_round = snapshot_round
        self.rounds = scn.rounds
        self.pc = scn.mode == "pc"
        # gates only ever open at link additions, so a scenario with
        # none can skip the pong/flush phases in every segment
        self.gating = scn.n_adds > 0

        self.cw = cw if cw is not None else ColumnWindow(
            scn, w, horizon=horizon)
        # the id space is the window's (the live subclass reserves
        # capacity beyond the scenario's pre-scripted broadcasts)
        self.m_app = self.cw.m_app_cap
        self.m_total = self.m_app + scn.n_adds
        n = scn.n
        if collect == "auto":
            collect = ("full" if n * max(self.m_total, 1) <= (1 << 26)
                       else "aggregate")
        if collect not in ("full", "aggregate"):
            raise ValueError(f"unknown collect mode {collect!r}")
        self.collect = collect

        self.st = state_to_device(init_topo_state(scn, w), dev)
        self._seg_series = torch.zeros((seg_len, len(SERIES_FIELDS)),
                                       dtype=torch.int64, device=dev)
        self.series = np.zeros((self.rounds, len(SERIES_FIELDS)), np.int64)
        self.delivered_full = (np.full((n, self.m_total), -1, np.int32)
                               if collect == "full" else None)
        self.deliv_count = np.zeros(self.m_total, np.int64)
        self.deliv_round_sum = np.zeros(self.m_total, np.int64)
        self.bcast_done = np.zeros(self.m_app, bool)
        self.expired = np.zeros(self.m_total, bool)
        self.first_receipts = 0
        self.lat_sum = 0
        self.lat_cnt = 0
        self.snapshot: Optional[Dict[str, np.ndarray]] = None
        self.t = 0
        self.segments = 0
        self.sweeps = 0
        self.app_sweeps = 0
        # the last retire_reduce columns, valid until the next span runs
        self._red: Optional[Tuple[np.ndarray, ...]] = None

    @property
    def done(self) -> bool:
        return self.t >= self.rounds

    def _run_segment(self, lo: int, hi: int) -> None:
        scn = self.scn
        ds = DeviceSchedule(self.cw.seg_schedule(lo, hi), self.device)
        seg = self._seg_series[: hi - lo]
        run_span(self.st, ds, lo, hi, seg, pc=self.pc,
                 always_gate=scn.always_gate, pong_delay=scn.pong_delay,
                 gating=self.gating)
        self.series[lo:hi] = host(seg)
        self._red = None

    def _reduce(self, gate, active, crashed):
        """The ``retire_reduce`` columns over the live planes, on the
        host: ``(cnt, alivedel, blocked, arrcnt, sumdel)`` as int64."""
        gated = (gate >= 0) & active & ~crashed[:, None]
        min_gate = np.where(gated, gate, INF).min(axis=1).astype(np.int32)
        red = kx.retire_reduce(self.st["arr"], self.st["delivered"],
                               self.st["crashed"],
                               torch.from_numpy(min_gate).to(self.device),
                               self.rounds)
        return tuple(host(x).astype(np.int64) for x in red)

    def _tables(self):
        return tuple(host(self.st[key])
                     for key in ("gate", "ping", "flush", "active",
                                 "crashed"))

    def _record_and_free(self, cols: np.ndarray, by_expiry: np.ndarray,
                         red, t_now: Optional[int] = None) -> None:
        """Fold retired columns into the aggregates from the
        ``retire_reduce`` columns ``red = (cnt, arrcnt, sumdel)``, feed
        the telemetry, and recycle them (reset on the device)."""
        if not len(cols):
            return
        st, cw, dev = self.st, self.cw, self.device
        ids = cw.slot_msg[cols]
        app = cw.slot_app[cols]
        cnt, arrcnt, sumdel = red
        self.deliv_count[ids] = cnt[cols]
        self.deliv_round_sum[ids] = sumdel[cols]
        self.first_receipts += int(arrcnt[cols].sum())
        delivered = st["delivered"]
        if app.any():
            acols, aidx = cols[app], ids[app]
            births = cw.slot_birth[acols].astype(np.int64)
            self.lat_sum += int((sumdel[acols] - cnt[acols] * births).sum())
            self.lat_cnt += int(cnt[acols].sum())
            self.app_sweeps += 1
            acols_t = torch.from_numpy(acols).to(dev)
            if self.hist:
                # latency histogram fold, once per column at retirement,
                # from the live plane: the base is the column's birth
                # round (batch) or the live loop's submission round
                lb = self.obs.latency_base
                base = (lb[aidx] if lb is not None
                        else cw.slot_birth[acols]).astype(np.int32)
                h = kx.latency_hist(torch.from_numpy(base).to(dev),
                                    delivered, torch.from_numpy(acols))
                self.obs.add_hist(host(h.sum(dim=0, dtype=torch.int64)))
            fl = self._flight
            if fl is not None and fl.open_count:
                # sampled provenance: the per-receiver delivery rounds of
                # the retiring *sampled* app columns, before the reset
                m = fl.sampled_mask(aidx)
                if m.any():
                    sel = torch.from_numpy(acols[m]).to(dev)
                    fl.on_retire(aidx[m],
                                 host(delivered.index_select(1, sel)),
                                 self.t if t_now is None else t_now,
                                 by_expiry[app][m])
            st["ever_del"] |= (delivered.index_select(1, acols_t)
                               >= 0).any(dim=1)
            orig = torch.from_numpy(
                cw.bc_origin[aidx].astype(np.int64)).to(dev)
            self.bcast_done[aidx] = host(delivered[orig, acols_t] >= 0)
        self.expired[ids] |= by_expiry
        cols_t = torch.from_numpy(cols).to(dev)
        if self.delivered_full is not None:
            self.delivered_full[:, ids] = host(
                delivered.index_select(1, cols_t))
        st["arr"].index_fill_(1, cols_t, int(INF))
        delivered.index_fill_(1, cols_t, -1)
        cw.slot_msg[cols] = -1

    def _retire(self, t_now: int) -> int:
        """Retire every column the monolithic run could no longer touch
        (plus horizon expiries); returns how many were freed."""
        cw, w = self.cw, self.w
        slot_msg, slot_birth, slot_app = (cw.slot_msg, cw.slot_birth,
                                          cw.slot_app)
        live = slot_msg >= 0
        if not live.any():
            return 0
        gate, ping, flush, active, crashed = self._tables()
        alive = ~crashed
        cnt, alivedel, blockcnt, arrcnt, sumdel = self._reduce(
            gate, active, crashed)
        self.sweeps += 1
        self._red = (cnt, arrcnt, sumdel)
        full_del = alivedel == int(alive.sum())
        blocked = (blockcnt > 0) & slot_app
        ref = np.zeros(w, bool)
        ref[ping[(ping >= 0) & ~crashed[:, None]]] = True
        dead = (cnt == 0) & (slot_birth < t_now)
        done = live & ~ref & ((full_del & ~blocked) | dead)
        by_exp = np.zeros(w, bool)
        if self.horizon is not None:
            by_exp = live & ~done & (t_now - slot_birth > self.horizon)
            hung = by_exp & ref
            if hung.any():
                # a gate whose ping column is being force-expired can
                # never resolve: clear it so the link goes safe and the
                # slot stops pinning the column — the buffered messages
                # it would have flushed are dropped, the documented
                # price of the horizon.
                sel = (ping >= 0) & hung[np.clip(ping, 0, w - 1)]
                gate[sel], flush[sel], ping[sel] = -1, INF, -1
                for key, val in (("gate", gate), ("flush", flush),
                                 ("ping", ping)):
                    self.st[key].copy_(torch.from_numpy(val))
            done |= by_exp
        fl = self._flight
        if fl is not None and fl.open_count:
            blk = np.nonzero(live & blocked & ~done)[0]
            if len(blk):
                bids = slot_msg[blk]
                m = fl.sampled_mask(bids)
                if m.any():
                    fl.on_blocked(bids[m], t_now)
        cols = np.nonzero(done)[0]
        self._record_and_free(cols, by_exp[cols], self._red, t_now)
        return len(cols)

    def advance(self) -> int:
        """Run one segment (activate -> span -> retire); returns the new
        current round.  May raise :class:`WindowOverflowError` from
        ``activate`` with the engine state untouched since the previous
        segment boundary."""
        t = self.t
        if t >= self.rounds:
            return t
        t_end = min(t + self.seg_len, self.rounds)
        if self.snapshot_round is not None and t <= self.snapshot_round:
            t_end = min(t_end, self.snapshot_round + 1)
        b0 = self.cw.next_bc
        t_end = self.cw.activate(t, t_end)
        fl = self._flight
        if fl is not None and self.cw.next_bc > b0:
            b1 = self.cw.next_bc
            fl.on_activate(np.arange(b0, b1), self.cw.bc_origin[b0:b1],
                           self.cw.bc_round[b0:b1])
        self._rec.begin(self._sid["dispatch"])
        self._run_segment(t, t_end)
        self._rec.end()
        self.segments += 1
        if (self.snapshot_round is not None
                and t_end - 1 == self.snapshot_round):
            self.snapshot = state_to_host(self.st)
            self.snapshot["is_app"] = self.cw.slot_app.copy()
            self.snapshot["slot_msg"] = self.cw.slot_msg.copy()
        self._rec.begin(self._sid["retire"])
        self._retire(t_end)
        self._rec.end()
        if self.obs is not None:
            seg = self.series[t:t_end]
            self.obs.gauge("piggyback_bytes",
                           16 * int(seg[:, 1].sum() + seg[:, 3].sum())
                           + 24 * int(seg[:, 2].sum()))
            self.obs.gauge("window_occupancy",
                           int((self.cw.slot_msg >= 0).sum()))
        self.t = t_end
        return t_end

    def finish(self) -> WindowedRunResult:
        """Drain still-live columns and build the run result.  Whatever
        is still live keeps its end-of-run values, exactly like the
        monolithic matrices at ``t == rounds``; its reductions are the
        last segment's, taken on these same planes."""
        live_cols = np.nonzero(self.cw.slot_msg >= 0)[0]
        if len(live_cols):
            red = self._red
            if red is None:
                gate, _, _, active, crashed = self._tables()
                cnt, _, _, arrcnt, sumdel = self._reduce(gate, active,
                                                         crashed)
                red = (cnt, arrcnt, sumdel)
            self._record_and_free(live_cols, np.zeros(len(live_cols), bool),
                                  red)
        stats = stats_from_series(self.series, self.first_receipts)
        return WindowedRunResult(
            scenario=self.scn, window=self.w, device=str(self.device),
            stats=stats, series=self.series, delivered=self.delivered_full,
            deliv_count=self.deliv_count, bcast_done=self.bcast_done,
            expired=self.expired, state=state_to_host(self.st),
            snapshot=self.snapshot, peak_live=self.cw.peak_live,
            lat_sum=self.lat_sum, lat_cnt=self.lat_cnt,
            deliv_round_sum=self.deliv_round_sum, segments=self.segments,
            sweeps=self.sweeps, app_sweeps=self.app_sweeps)


def execute_windowed(scn: VecScenario, window: int, device=None,
                     horizon: Optional[int] = None, seg_len: int = 32,
                     snapshot_round: Optional[int] = None,
                     collect: str = "auto", obs=None) -> WindowedRunResult:
    """Run ``scn`` through a ``window``-column streaming buffer.

    ``horizon`` — force-retire columns older than this many rounds
    (default: never; exactness preserved).  ``seg_len`` — rounds per
    segment between retirement sweeps.  ``collect`` — ``"full"`` keeps
    the (N, M_total) delivered matrix, ``"aggregate"`` keeps only
    per-message counters, ``"auto"`` picks by size.  ``device`` is the
    card unless ``"cpu"`` is asked for.  ``obs`` is the run's telemetry
    accumulator (:class:`~repro_torch.obs.spans.EngineObs`) or None.

    This is the engine behind ``repro_torch.api.run``; prefer the front
    door (``run(RunSpec(...))``) in new code."""
    stepper = WindowedStepper(scn, window, device=device, horizon=horizon,
                              seg_len=seg_len, snapshot_round=snapshot_round,
                              collect=collect, obs=obs)
    while not stepper.done:
        stepper.advance()
    return stepper.finish()
