"""``execute_sharded`` — the host driver of the sharded engine.

The twin of ``stream.execute_windowed`` with the process axis split over
``torch.distributed`` ranks (the JAX package's ``shard/driver.py`` over
a device mesh): the same :class:`~repro_torch.core.vecsim.stream.ColumnWindow`
activates messages into live columns and the same retirement
(``retire.py``, with this engine's rank group) recycles them, but each
rank keeps only its row block of the planes on its device for the whole
run.  The host never holds an ``(N, W)`` plane unless the run collects
the full delivered matrix (``collect="full"``, on rank 0).

All host bookkeeping — the window, the retirement decisions, the series
and the aggregates — is built only from summed values, never from the
wall clock, so it is identical on every rank; only rank 0 keeps the full
matrix, the snapshots and the final state, and only rank 0's result is
returned by the front door.

``scan="on"`` (and ``"auto"``) is the device-resident segment loop:
schedules stage through segment-persistent device buffers that skip the
upload when a field's content is unchanged, with the next segment's
activation-independent fields staged while the current one runs; the
generic body defers the frontier exchange through a ``pending`` plane;
the retirement aggregates are computed at the end of the segment; and
topology-quiescent segments of a run without live gating take the
bit-packed fast body, whose inverse tables are cached by topology
content.  ``"off"`` steps every round through the generic body with the
exchange scattered straight into ``arr``.  The two are byte-identical,
and both equal the windowed engine on every scenario both can run.

The segment loop is a stepper (:class:`ShardedStepper`, one
``advance()`` a segment) so that the live serving loop can admit traffic
between segments.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ....backend import resolve_device
from ....obs.spans import NULL_RECORDER
from ..scenario import INF, VecScenario
from ..retire import Retirer, resolve_collect
from ..sim import (_FAMILIES as _SIM_FAMILIES, SERIES_FIELDS, STATE_KEYS,
                   host, init_topo_state, stats_from_series)
from ..stream import ColumnWindow, WindowedRunResult
from .mesh import (ShardGroup, inverse_tables, pad_rows, resolve_world,
                   topology_digest)
from .spanner import (INT16_LIMIT, fast_positions, fast_span, generic_span,
                      resolve_scan)

__all__ = ["ShardedRunResult", "ShardedStepper", "execute_sharded"]


@dataclass
class ShardedRunResult(WindowedRunResult):
    """A windowed-engine result produced by the sharded engine: the same
    fields, plus the rank count (``n_devices``), the resolved segment
    loop (``scan``), how many segments took the fast and the generic
    body, and — when profiled — one dict a segment with its ``lo``/``hi``
    rounds, whether it ran fast, and its ``stage_s``/``dispatch_s``/
    ``block_s``/``retire_s`` host times.  On ranks other than 0,
    ``delivered``, ``state`` and ``snapshot`` are None."""

    n_devices: int = 1
    scan: str = "off"
    fast_segments: int = 0
    generic_segments: int = 0
    seg_profile: Optional[List[dict]] = field(default=None, repr=False)


def _padded_state(scn: VecScenario, n_pad: int) -> Dict[str, np.ndarray]:
    """The host-built initial tables — everything but the ``(N, W)``
    planes, whose every cell starts at INF / -1 and which the stepper
    makes on the device — with inert padding rows: no links, crashed
    (so the all-alive retirement rule and the stats never see them)."""
    st = init_topo_state(scn, 0)
    del st["arr"], st["delivered"]
    extra = n_pad - scn.n
    if not extra:
        return st
    pad = dict(
        adj=np.full((extra, scn.k), -1, np.int32),
        delay=np.ones((extra, scn.k), np.int32),
        active=np.zeros((extra, scn.k), bool),
        gate=np.full((extra, scn.k), -1, np.int32),
        flush=np.full((extra, scn.k), INF, np.int32),
        ping=np.full((extra, scn.k), -1, np.int32),
        crashed=np.ones(extra, bool),
        ever_del=np.zeros(extra, bool),
    )
    return {key: np.concatenate([st[key], pad[key]]) for key in st}


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of the host array ``a``.  On the card it goes
    through pinned memory without a wait, so staging the next segment
    does not stall on the one the card is running."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


# event family -> (round field, (device field, is a process row) ...):
# sim's families, with the fields that are process rows flagged
_ROWS = frozenset(("bc_origin", "add_p", "rm_p", "cr_pid"))
_FAMILIES = {fam: (rnd, tuple((name, name in _ROWS) for name in flds))
             for fam, (rnd, flds) in _SIM_FAMILIES.items()}
_FIELDS = frozenset(name for _, flds in _FAMILIES.values()
                    for name, _ in flds)
# fields whose content depends on column assignment (``activate``)
_ACTIVATION_FIELDS = frozenset(("bc_slot", "add_slot"))


def _segment_events(cw: ColumnWindow, lo: int, hi: int, off: int,
                    n_loc: int, fields) -> Dict[str, np.ndarray]:
    """This rank's events of rounds ``[lo, hi)`` as host arrays: the
    round of each family (key ``<fam>``) and the asked-for ``fields``,
    process rows made local.  Events stay in round order."""
    src = {
        "bc_round": cw.bc_round[: cw.m_bc], "bc_origin": cw.bc_origin,
        "bc_slot": cw.bc_live_slot,
        "add_round": cw.add_round_s, "add_p": cw.add_p_s,
        "add_k": cw.add_k_s, "add_q": cw.add_q_s,
        "add_delay": cw.add_delay_s,
        "add_slot": lambda: cw.add_live_slot[cw.add_ord],
        "rm_round": cw.rm_round_s, "rm_p": cw.rm_p_s, "rm_k": cw.rm_k_s,
        "cr_round": cw.cr_round_s, "cr_pid": cw.cr_pid_s,
    }
    out: Dict[str, np.ndarray] = {}
    for fam, (round_name, flds) in _FAMILIES.items():
        rs = src[round_name]
        i0, i1 = np.searchsorted(rs, [lo, hi])
        rows = np.asarray(src[flds[0][0]][i0:i1], np.int64) - off
        own = (rows >= 0) & (rows < n_loc)
        out[fam] = np.asarray(rs[i0:i1])[own]
        for name, is_row in flds:
            if name not in fields:
                continue
            a = src[name]() if callable(src[name]) else src[name]
            v = np.asarray(a[i0:i1], np.int64)
            out[name] = ((v - off) if is_row else v)[own].astype(np.int32)
    return out


class _Schedule:
    """One segment's owned events on the device: ``events(fam, t)``
    slices round ``t``'s events by a binary search of the host copy of
    the rounds, so selecting a round costs the device nothing (the
    contract of :func:`~repro_torch.core.vecsim.sim.apply_events`)."""

    def __init__(self, rounds: Dict[str, np.ndarray],
                 dev: Dict[str, torch.Tensor], is_app: torch.Tensor):
        self.rounds = rounds
        self.dev = dev
        self.is_app = is_app

    def events(self, fam: str, t: int):
        rs = self.rounds[fam]
        i0, i1 = np.searchsorted(rs, [t, t + 1])
        if i0 == i1:
            return None
        return [self.dev[name][i0:i1] for name, _ in _FAMILIES[fam][1]]


def _fresh_schedule(cw: ColumnWindow, lo: int, hi: int, group: ShardGroup,
                    n_loc: int) -> _Schedule:
    """Segment ``[lo, hi)``'s schedule built and uploaded anew (the
    ``scan="off"`` path)."""
    ev = _segment_events(cw, lo, hi, group.off, n_loc, _FIELDS)
    rounds = {fam: ev.pop(fam) for fam in _FAMILIES}
    return _Schedule(rounds, {key: _put(v, group.device)
                              for key, v in ev.items()},
                     _put(cw.slot_app, group.device))


class _SegmentStager:
    """Segment-persistent schedule staging for ``scan="on"``.

    One device buffer a schedule field, reused across segments: a field
    is uploaded only when its host content changed (quiescent segments
    reuse the empty buffers already on the device), and the
    activation-independent fields of segment k+1 — everything but
    ``bc_slot``, ``add_slot`` and ``is_app`` — are staged while segment
    k runs (:meth:`prefetch`).  A mispredicted prefetch is rebuilt in
    :meth:`stage`, and the content comparison keeps it from ever being
    used."""

    PREFETCHABLE = _FIELDS - _ACTIVATION_FIELDS

    def __init__(self, cw: ColumnWindow, seg_len: int, rounds: int,
                 group: ShardGroup, n_loc: int, rec=None):
        self.cw = cw
        self.seg_len = seg_len
        self.rounds = rounds
        self.group = group
        self.n_loc = n_loc
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        self.pending: Optional[tuple] = None
        self.uploads = 0
        self.skips = 0
        self.rec = rec if rec is not None else NULL_RECORDER
        self._sid_upload = self.rec.name("stager.upload")

    def put(self, key: str, host_arr: np.ndarray) -> torch.Tensor:
        """The device buffer of ``key`` holding ``host_arr``, uploaded
        only if the content changed since the last call."""
        old = self.host.get(key)
        if old is None or not np.array_equal(old, host_arr):
            # a copy: some sources alias window arrays that change in
            # place between segments
            self.host[key] = np.array(host_arr, copy=True)
            self.uploads += 1
            self.rec.begin(self._sid_upload)
            self.dev[key] = _put(self.host[key], self.group.device)
            self.rec.end()
        else:
            self.skips += 1
        return self.dev[key]

    def _build(self, lo: int, hi: int, fields):
        ev = _segment_events(self.cw, lo, hi, self.group.off, self.n_loc,
                             fields)
        rounds = {fam: ev.pop(fam) for fam in _FAMILIES}
        return rounds, {key: self.put(key, v) for key, v in ev.items()}

    def prefetch(self, lo: int) -> None:
        """Stage segment ``[lo, lo + seg_len)``'s activation-independent
        fields now, while the segment before it runs."""
        hi = min(lo + self.seg_len, self.rounds)
        self.pending = (None if lo >= hi else
                        (lo, hi, self._build(lo, hi, self.PREFETCHABLE)))

    def stage(self, lo: int, hi: int) -> _Schedule:
        """The schedule of segment ``[lo, hi)``: the prefetched fields
        when the prediction held, the rest built and compared now."""
        if self.pending is not None and self.pending[:2] == (lo, hi):
            rounds, dev = self.pending[2]
            dev = dict(dev)
        else:
            rounds, dev = self._build(lo, hi, self.PREFETCHABLE)
        dev.update(self._build(lo, hi, _ACTIVATION_FIELDS)[1])
        self.pending = None
        is_app = self.put("is_app", self.cw.slot_app)
        return _Schedule(rounds, dev, is_app)


class ShardedStepper:
    """The sharded engine, one segment per :meth:`advance` call — the
    twin of :class:`~repro_torch.core.vecsim.stream.WindowedStepper`
    with the same stepping semantics.  ``n_devices`` is the rank count
    (None: the process group's, 1 without one); ``device`` is the card
    unless ``"cpu"`` is asked for.  ``cw`` optionally supplies an
    externally built window (the live loop passes its growable subclass;
    when it flags ``mutable_schedule`` nothing is prefetched, since the
    next segment's traffic is not admitted yet)."""

    def __init__(self, scn: VecScenario, window: int,
                 n_devices: Optional[int] = None, device=None,
                 horizon: Optional[int] = None, seg_len: int = 32,
                 snapshot_round: Optional[int] = None,
                 collect: str = "auto", scan: str = "auto",
                 profile: bool = False,
                 cw: Optional[ColumnWindow] = None, obs=None):
        dev = resolve_device(device)
        self.scan = scan = resolve_scan(scan)
        rank, world = resolve_world(n_devices, dev)
        self.d = world
        self.w = w = int(window)
        if w < 1:
            raise ValueError("window must be >= 1")
        self.seg_len = seg_len = max(1, int(seg_len))
        self.scn = scn
        self.horizon = None if horizon is None else int(horizon)
        self.snapshot_round = snapshot_round
        n = scn.n
        self.n_pad = n_pad = pad_rows(n, world)
        self.n_loc = n_loc = n_pad // world
        self.group = group = ShardGroup(rank, world, dev, rank * n_loc)
        self.rounds = rounds = scn.rounds
        self.pc = pc = scn.mode == "pc"
        # gates only ever open at link additions
        self.gating = gating = scn.n_adds > 0

        self.cw = cw = cw if cw is not None else ColumnWindow(
            scn, w, horizon=horizon)
        self.collect = resolve_collect(collect, n, cw.m_app_cap + scn.n_adds)

        st0 = _padded_state(scn, n_pad)
        rows = slice(group.off, group.off + n_loc)
        self.st = {key: _put(a[rows], dev) for key, a in st0.items()}
        self.st["arr"] = torch.full((n_loc, w), int(INF), dtype=torch.int32,
                                    device=dev)
        self.st["delivered"] = torch.full((n_loc, w), -1, dtype=torch.int32,
                                          device=dev)
        if scan == "on":
            # host mirror of the padded topology tables, advanced past
            # each segment's add/rm events, so the fast body's inverse
            # tables are built from the segment-entry topology
            self.topo_adj = st0["adj"].copy()
            self.topo_delay = st0["delay"].copy()
            self.topo_active = st0["active"].copy()
        del st0

        self.series = np.zeros((rounds, len(SERIES_FIELDS)), np.int64)
        self._seg_series = torch.zeros((seg_len, len(SERIES_FIELDS)),
                                       dtype=torch.int64, device=dev)
        self.snapshot: Optional[Dict[str, np.ndarray]] = None
        self.seg_profile: Optional[List[dict]] = [] if profile else None
        self._clock = time.perf_counter
        self.t = 0
        self.segments = 0
        self.fast_segments = self.generic_segments = 0

        # telemetry: the segment bodies are telemetry-free; the
        # retirement folds the latency histogram and the flight
        # recorder's rows, gathered on every rank (its state stays
        # replicated), and records no span of its own
        self.obs = obs
        self._rec = obs.spans if obs is not None else NULL_RECORDER
        self._sid = {name: self._rec.name(f"segment.{name}")
                     for name in ("stage", "dispatch", "block", "retire")}
        self._flight = getattr(obs, "flight", None)
        self.retirer = Retirer(scn, cw, self.st, self.horizon, self.collect,
                               group, lambda a: _put(a, dev), obs)

        if scan == "on":
            self.stager = _SegmentStager(cw, seg_len, rounds, group, n_loc,
                                         rec=self._rec)
            # The fast body needs the gating machinery quiescent for the
            # whole run (gate/flush/ping state can straddle segments)
            # and the arrival clock to fit int16; per segment also no
            # add/rm events.
            max_dl = int(max(self.topo_delay.max(initial=1),
                             scn.add_delay.max(initial=1)))
            self.fast_allowed = (not (pc and gating)
                                 and rounds + max_dl < INT16_LIMIT - 1)
            self.fast_tabs: Optional[tuple] = None
            # inverse tables keyed by topology content
            self.tab_cache: Dict[bytes, tuple] = {}

    @property
    def done(self) -> bool:
        return self.t >= self.rounds

    # ------------------------------------------------------------ helpers
    def _seg_topo_events(self, lo: int, hi: int):
        cw = self.cw
        a0, a1 = np.searchsorted(cw.add_round_s, [lo, hi])
        r0, r1 = np.searchsorted(cw.rm_round_s, [lo, hi])
        return int(a0), int(a1), int(r0), int(r1)

    def _apply_topo_events(self, lo: int, hi: int) -> None:
        """Advance the host topology mirror past segment ``[lo, hi)``
        (phases 1-2: additions set adj/delay/active, removals
        deactivate)."""
        cw = self.cw
        a0, a1, r0, r1 = self._seg_topo_events(lo, hi)
        if a1 > a0:
            p, k = cw.add_p_s[a0:a1], cw.add_k_s[a0:a1]
            self.topo_adj[p, k] = cw.add_q_s[a0:a1]
            self.topo_delay[p, k] = cw.add_delay_s[a0:a1]
            self.topo_active[p, k] = True
        if r1 > r0:
            self.topo_active[cw.rm_p_s[r0:r1], cw.rm_k_s[r0:r1]] = False
        if a1 > a0 or r1 > r0:
            self.fast_tabs = None

    def _fast_classes(self):
        """``(delay, positions)`` per delay class of the segment-entry
        topology, from the content-keyed cache (16 entries)."""
        if self.fast_tabs is None:
            key = topology_digest(self.topo_adj, self.topo_delay,
                                  self.topo_active)
            ent = self.tab_cache.get(key)
            if ent is None:
                sig, tabs = inverse_tables(self.topo_adj, self.topo_delay,
                                           self.topo_active)
                rows = slice(self.group.off, self.group.off + self.n_loc)
                pos = fast_positions(
                    [_put(tb[rows], self.group.device) for tb in tabs],
                    self.group, self.n_loc)
                ent = tuple((dl, p) for (dl, _), p in zip(sig, pos))
                if len(self.tab_cache) >= 16:
                    self.tab_cache.pop(next(iter(self.tab_cache)))
                self.tab_cache[key] = ent
            self.fast_tabs = ent
        return self.fast_tabs

    def _gather_host(self, x: torch.Tensor, everywhere: bool = False):
        """Every rank's rows of the local tensor ``x`` on the host,
        padding rows dropped (on rank 0, or on every rank)."""
        g = self.group.gather_rows(x, everywhere=everywhere)
        return None if g is None else host(g)[: self.scn.n]

    def host_state(self) -> Optional[Dict[str, np.ndarray]]:
        """The whole state on rank 0 (None elsewhere); every rank must
        call it."""
        out = {key: self._gather_host(self.st[key]) for key in STATE_KEYS}
        return out if self.group.rank == 0 else None

    # ----------------------------------------------------------- segment
    def _run_segment(self, lo: int, hi: int):
        """Run segment ``[lo, hi)``; returns its device stats rows
        (local) and, on ``scan="on"`` with live columns, the summed
        retirement aggregates of the segment's end."""
        cw, group, rec, sid = self.cw, self.group, self._rec, self._sid
        self.retirer.stale()
        t0 = self._clock()
        rec.begin(sid["stage"])
        fast = False
        if self.scan == "off":
            sched = _fresh_schedule(cw, lo, hi, group, self.n_loc)
        else:
            a0, a1, r0, r1 = self._seg_topo_events(lo, hi)
            fast = self.fast_allowed and a1 == a0 and r1 == r0
            sched = self.stager.stage(lo, hi)
            if fast:
                classes = self._fast_classes()
                ia = np.packbits(
                    np.concatenate([cw.slot_app,
                                    np.zeros((-self.w) % 8, bool)]),
                    bitorder="little")
                ia_dev = self.stager.put("__ia_pack", ia)
        rec.end()
        t1 = self._clock()
        rec.begin(sid["dispatch"])
        seg = self._seg_series[: hi - lo]
        if fast:
            fast_span(self.st, sched, lo, hi, seg, group=group,
                      classes=classes, ia_pack=ia_dev)
            self.fast_segments += 1
        else:
            scn = self.scn
            generic_span(self.st, sched, lo, hi, seg, group=group,
                         pc=self.pc, always_gate=scn.always_gate,
                         pong_delay=scn.pong_delay, gating=self.gating,
                         deferred=self.scan == "on")
            self.generic_segments += 1
        red = None
        if self.scan == "on" and (cw.slot_msg >= 0).any():
            # the retirement aggregates of the segment's end, enqueued
            # with the segment itself
            red = self.retirer.partials()
        rec.end()
        if self.scan == "on":
            self._apply_topo_events(lo, hi)
        if self.seg_profile is not None:
            self.seg_profile.append(dict(lo=lo, hi=hi, fast=fast,
                                         stage_s=t1 - t0,
                                         dispatch_s=self._clock() - t1))
        return seg, red

    # --------------------------------------------------------------- loop
    def advance(self) -> int:
        """Run one segment (activate -> run -> retire); returns the new
        current round.  May raise
        :class:`~repro_torch.core.vecsim.stream.WindowOverflowError`
        from ``activate`` with the engine state untouched since the
        previous segment boundary."""
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
        seg, red_dev = self._run_segment(t, t_end)
        self.segments += 1
        if self.scan == "on" and not self.cw.mutable_schedule:
            # stage segment k+1's activation-independent fields while
            # segment k runs (pre-scripted runs only: a live window
            # admits segment k+1's traffic after this one ends)
            self.stager.prefetch(t_end)
        t0 = self._clock()
        self._rec.begin(self._sid["block"])
        self.series[t:t_end] = host(self.group.all_reduce_sum(seg))
        if (self.snapshot_round is not None
                and t_end - 1 == self.snapshot_round):
            snap = self.host_state()
            if snap is not None:
                snap["is_app"] = self.cw.slot_app.copy()
                snap["slot_msg"] = self.cw.slot_msg.copy()
            self.snapshot = snap
        self._rec.end()
        t1 = self._clock()
        self._rec.begin(self._sid["retire"])
        self.retirer.sweep(t_end, red_dev)
        self._rec.end()
        if self.seg_profile is not None:
            self.seg_profile[-1]["block_s"] = t1 - t0
            self.seg_profile[-1]["retire_s"] = self._clock() - t1
        if self.obs is not None:
            s = self.series[t:t_end]
            self.obs.gauge("piggyback_bytes",
                           16 * int(s[:, 1].sum() + s[:, 3].sum())
                           + 24 * int(s[:, 2].sum()))
            self.obs.gauge("window_occupancy",
                           int((self.cw.slot_msg >= 0).sum()))
        self.t = t_end
        return t_end

    def finish(self) -> ShardedRunResult:
        """Drain still-live columns and build the result: whatever is
        still live keeps its end-of-run values, as in the windowed
        engine at ``t == rounds``."""
        self.retirer.drain(self.t)
        if self.obs is not None and self.scan == "on":
            self.obs.count("stager_uploads", self.stager.uploads)
            self.obs.count("stager_skips", self.stager.skips)
        stats = stats_from_series(self.series, self.retirer.first_receipts)
        return ShardedRunResult(
            scenario=self.scn, window=self.w, device=str(self.group.device),
            stats=stats, series=self.series, state=self.host_state(),
            snapshot=self.snapshot, peak_live=self.cw.peak_live,
            segments=self.segments, **self.retirer.result_fields(),
            n_devices=self.d, scan=self.scan,
            fast_segments=self.fast_segments,
            generic_segments=self.generic_segments,
            seg_profile=self.seg_profile)


def execute_sharded(scn: VecScenario, window: int,
                    n_devices: Optional[int] = None, device=None,
                    horizon: Optional[int] = None, seg_len: int = 32,
                    snapshot_round: Optional[int] = None,
                    collect: str = "auto", scan: str = "auto",
                    profile: bool = False, obs=None) -> ShardedRunResult:
    """Run ``scn`` through a ``window``-column streaming buffer whose
    process rows are split over ``n_devices`` ranks (None: the process
    group's, 1 without one).  Parameters match
    :func:`~repro_torch.core.vecsim.stream.execute_windowed`; ``device``
    is the card unless ``"cpu"`` is asked for.  ``scan`` picks the
    segment loop (``"auto"``/``"on"`` or ``"off"``, byte-identical);
    ``profile=True`` records the per-segment host times on the result
    (``seg_profile``).  Several ranks need a process group: every rank
    calls this with the same arguments (``repro_torch.api.run`` starts
    them).

    This is the engine behind ``repro_torch.api.run`` with
    ``engine="sharded"``; prefer the front door in new code."""
    stepper = ShardedStepper(scn, window, n_devices=n_devices, device=device,
                             horizon=horizon, seg_len=seg_len,
                             snapshot_round=snapshot_round, collect=collect,
                             scan=scan, profile=profile, obs=obs)
    while not stepper.done:
        stepper.advance()
    return stepper.finish()
