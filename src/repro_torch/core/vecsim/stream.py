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
  * between segments, columns are **retired** exactly, by the rule and
    fold that the sharded engine shares (``retire.py``): their
    per-message results fold into aggregates and the column is recycled.

The ``arr``/``delivered`` planes never leave the device.  Per segment
the host reads the segment's stats rows and one flat vector of
per-column aggregates reduced on the card; retiring columns are
recorded from it and reset on the device, and only with
``collect="full"`` is their ``delivered`` slice copied to the host.  At
the finish, once the drain has reset every column, the planes are
checked on the device to hold only their reset values and reach the
host as read-only constants, never copied.

Telemetry (``repro_torch.obs``, threaded in as ``obs=``) hooks in where
the JAX stepper hooks it: the retirement folds the latency histogram
and the flight recorder's sampled columns (``retire.py``), and spans
name every phase of the set-up, each segment and the finish, down to
each blocking copy between host and card (the tree is in
``obs/spans.py``).  On the card ``segment.dispatch`` ends with the read
of the segment's stats, ``segment.wait``, which waits for its rounds;
``segment.retire`` starts after it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ...backend import resolve_device
from ...obs.spans import NULL_RECORDER
from ..types import NetStats
from .retire import OneDevice, Retirer, resolve_collect
from .scenario import INF, VecScenario
from .sim import (SERIES_FIELDS, STATE_KEYS, DeviceSchedule, SlotSchedule,
                  host, init_device_state, run_span, state_to_host,
                  stats_from_series, to_device)

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
    # final topology state; after a finish its (N, W) planes "arr" and
    # "delivered" are read-only constants (INF, -1): the drain resets them
    state: Dict[str, np.ndarray]
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

    #: set by the live subclass: the schedule grows between segments, so
    #: a driver must not stage a segment's schedule ahead of time
    mutable_schedule = False

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

    def live_cols(self) -> np.ndarray:
        return np.nonzero(self.slot_msg >= 0)[0]

    def free_cols(self, cols: np.ndarray) -> None:
        self.slot_msg[cols] = -1


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
        self._rec = rec = obs.spans if obs is not None else NULL_RECORDER
        self._sid = {name: rec.name(name) for name in (
            "engine.setup", "engine.finish", "segment.activate",
            "segment.dispatch", "segment.upload", "segment.enqueue",
            "segment.wait", "segment.snapshot", "segment.retire",
            "segment.activated", "segment.retired", "segment.blocked")}
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
        self.collect = resolve_collect(collect, scn.n,
                                       self.cw.m_app_cap + scn.n_adds)

        rec.begin(self._sid["engine.setup"])
        self.st = init_device_state(scn, w, dev, rec)
        self._seg_series = torch.zeros((seg_len, len(SERIES_FIELDS)),
                                       dtype=torch.int64, device=dev)
        self.series = np.zeros((self.rounds, len(SERIES_FIELDS)), np.int64)
        self.retirer = Retirer(
            scn, self.cw, self.st, self.horizon, self.collect,
            OneDevice(), lambda a: to_device(a, dev, rec), obs, rec)
        self.snapshot: Optional[Dict[str, np.ndarray]] = None
        self.t = 0
        self.segments = 0
        rec.end()

    @property
    def done(self) -> bool:
        return self.t >= self.rounds

    def _run_segment(self, lo: int, hi: int) -> None:
        scn, rec, sid = self.scn, self._rec, self._sid
        rec.begin(sid["segment.upload"])
        ds = DeviceSchedule(self.cw.seg_schedule(lo, hi), self.device, rec)
        rec.end()
        seg = self._seg_series[: hi - lo]
        rec.begin(sid["segment.enqueue"])
        run_span(self.st, ds, lo, hi, seg, pc=self.pc,
                 always_gate=scn.always_gate, pong_delay=scn.pong_delay,
                 gating=self.gating)
        rec.end()
        rec.begin(sid["segment.wait"])
        self.series[lo:hi] = host(seg, rec)
        rec.end()
        self.retirer.stale()

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
        cw, rec, sid = self.cw, self._rec, self._sid
        b0, a0 = cw.next_bc, cw.next_add
        rec.begin(sid["segment.activate"])
        try:
            t_end = cw.activate(t, t_end)
            fl = self._flight
            if fl is not None and cw.next_bc > b0:
                b1 = cw.next_bc
                fl.on_activate(np.arange(b0, b1), cw.bc_origin[b0:b1],
                               cw.bc_round[b0:b1])
        finally:
            # an overflow raise leaves the window untouched, and the
            # live loop retries the segment
            rec.end()
        rec.counter(sid["segment.activated"],
                    cw.next_bc - b0 + cw.next_add - a0)
        rec.begin(sid["segment.dispatch"])
        self._run_segment(t, t_end)
        rec.end()
        self.segments += 1
        if (self.snapshot_round is not None
                and t_end - 1 == self.snapshot_round):
            rec.begin(sid["segment.snapshot"])
            self.snapshot = state_to_host(self.st, rec)
            rec.end()
            self.snapshot["is_app"] = cw.slot_app.copy()
            self.snapshot["slot_msg"] = cw.slot_msg.copy()
        rec.begin(sid["segment.retire"])
        freed, held = self.retirer.sweep(t_end)
        rec.counter(sid["segment.retired"], freed)
        rec.counter(sid["segment.blocked"], held)
        rec.end()
        if self.obs is not None:
            seg = self.series[t:t_end]
            self.obs.gauge("piggyback_bytes",
                           16 * int(seg[:, 1].sum() + seg[:, 3].sum())
                           + 24 * int(seg[:, 2].sum()))
            self.obs.gauge("window_occupancy",
                           int((self.cw.slot_msg >= 0).sum()))
        self.t = t_end
        return t_end

    def _drained_planes(self) -> Dict[str, np.ndarray]:
        """The two ``(N, W)`` planes after the drain, as read-only host
        constants of the planes' shape: one ``aminmax`` a plane on the
        device and one read of the four values check that every cell
        holds its reset value.  Raises ``RuntimeError`` naming the
        plane if one does not, since a column was then retired without
        its reset."""
        st = self.st
        bounds = host(torch.stack([*torch.aminmax(st["arr"]),
                                   *torch.aminmax(st["delivered"])]),
                      self._rec)
        planes = {}
        for i, (key, val) in enumerate((("arr", INF), ("delivered", -1))):
            lo, hi = (int(x) for x in bounds[2 * i: 2 * i + 2])
            if lo != val or hi != val:
                raise RuntimeError(
                    f"the drained {key!r} plane holds values in "
                    f"[{lo}, {hi}], not only its reset value {int(val)}: "
                    f"a column was retired without its reset")
            planes[key] = np.broadcast_to(np.int32(val),
                                          tuple(st[key].shape))
        return planes

    def finish(self) -> WindowedRunResult:
        """Drain still-live columns and build the run result.  The
        drain folds each still-live column from the last segment's
        reductions, taken on these same planes, and resets it like any
        retired column.  Every column of the window is then at its
        reset value (never used, retired and reset, or drained and
        reset), so the two ``(N, W)`` planes are checked on the device
        and not copied (:meth:`_drained_planes`); the eight ``(N, K)``
        and ``(N,)`` tables are read back."""
        rec = self._rec
        rec.begin(self._sid["engine.finish"])
        self.retirer.drain(self.t)
        stats = stats_from_series(self.series, self.retirer.first_receipts)
        planes = self._drained_planes()
        state = {key: planes[key] if key in planes
                 else host(self.st[key], rec) for key in STATE_KEYS}
        rec.end()
        return WindowedRunResult(
            scenario=self.scn, window=self.w, device=str(self.device),
            stats=stats, series=self.series, state=state,
            snapshot=self.snapshot, peak_live=self.cw.peak_live,
            segments=self.segments, **self.retirer.result_fields())


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
