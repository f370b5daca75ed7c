"""Vectorized lockstep-round execution of a :class:`VecScenario` in
PyTorch, on the card by default.

The whole network is dense tensors, as in the JAX package's
``repro.core.vecsim.sim``:

  * ``arr[q, m]``       — earliest known arrival round of message column
    ``m`` at process ``q`` (INF = never);
  * ``delivered[q, m]`` — delivery round (-1 = not yet);
  * ``adj/delay/active``— the ``(N, K)`` out-link slot table;
  * ``gate/flush/ping`` — per-slot ping-phase machinery (Algorithm 2):
    ``gate`` is the round the link was gated (-1 = safe), ``ping`` the
    message column its ping floods under, ``flush`` the round at which
    the pong arrives and the link's buffer is flushed;
  * ``crashed[p]``      — silent-crash flag; ``ever_del[p]`` — app
    deliveries of columns the windowed engine already retired.

Each round applies, in order: link removals, link additions (with the
Algorithm 2 gating decision), crashes, broadcasts, arrival deliveries,
pong detection, buffer flushes, and flood-forwarding of this round's
deliveries over safe links.  Phases 1-4 are small ``(E,)``/``(N, K)``
tensor updates (:func:`apply_events`); the ``(N, W)`` phases run in the
sweep kernels (``kernels.ops``): one fused deliver+forward sweep on
rounds without gating, or, when the scenario adds links under
PC-broadcast, a deliver sweep, the pong gather in PyTorch, and one
flush+forward sweep.

Schedules are round-sorted and uploaded once per span
(:class:`DeviceSchedule`); each round takes its events by slicing on
the host, so the round loop never waits on the device.  Per-round
statistics stay on the device and are read once per span.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ...backend import resolve_device
from ...obs.spans import NULL_RECORDER
from ..types import NetStats
from . import kernels as kx
from .scenario import INF, VecScenario

__all__ = ["SERIES_FIELDS", "STATE_KEYS", "SlotSchedule", "full_schedule",
           "VecRunResult", "init_topo_state", "init_device_state",
           "stats_from_series", "state_to_device", "state_to_host",
           "to_device", "DeviceSchedule",
           "apply_events", "pong_fire", "run_span", "execute_vec"]

# Wire-size model (bytes): an AppMsg id (origin, counter), a Ping
# (frm, to, id).
_CTRL_APP = 16
_CTRL_PING = 24

# Per-round stats, int64 (rounds, 6).
SERIES_FIELDS = ("deliveries", "sent_app", "sent_ping", "flush_sent",
                 "pongs", "gated")

STATE_KEYS = ("arr", "delivered", "adj", "delay", "active", "gate",
              "flush", "ping", "crashed", "ever_del")

_INF = int(INF)


@dataclass
class SlotSchedule:
    """Slot-space schedules for a span of rounds.

    ``bc_slot``/``add_slot`` name the message *column* of each broadcast
    / link-addition ping; ``is_app`` marks which columns carry app
    messages.  Rounds are absolute.  The monolithic run uses the
    identity mapping (:func:`full_schedule`); the windowed engine remaps
    onto live buffer columns per segment."""

    is_app: np.ndarray       # (W,) bool
    bc_round: np.ndarray     # (B,)
    bc_origin: np.ndarray    # (B,)
    bc_slot: np.ndarray      # (B,)
    add_round: np.ndarray    # (E,)
    add_p: np.ndarray
    add_k: np.ndarray
    add_q: np.ndarray
    add_delay: np.ndarray
    add_slot: np.ndarray     # (E,) ping column of each addition
    rm_round: np.ndarray     # (R,)
    rm_p: np.ndarray
    rm_k: np.ndarray
    cr_round: np.ndarray     # (C,)
    cr_pid: np.ndarray


def full_schedule(scn: VecScenario) -> SlotSchedule:
    """Identity slot mapping: column ``i`` is message ``i``, ping of
    addition ``e`` is column ``m_app + e``."""
    m_app = scn.m_app
    is_app = np.zeros(scn.m_total, bool)
    is_app[:m_app] = True
    return SlotSchedule(
        is_app=is_app,
        bc_round=scn.bcast_round, bc_origin=scn.bcast_origin,
        bc_slot=np.arange(m_app, dtype=np.int32),
        add_round=scn.add_round, add_p=scn.add_p, add_k=scn.add_k,
        add_q=scn.add_q, add_delay=scn.add_delay,
        add_slot=(m_app + np.arange(scn.n_adds)).astype(np.int32),
        rm_round=scn.rm_round, rm_p=scn.rm_p, rm_k=scn.rm_k,
        cr_round=scn.crash_round, cr_pid=scn.crash_pid)


@dataclass
class VecRunResult:
    scenario: VecScenario
    delivered: np.ndarray          # (N, M_total) delivery round, -1 = never
    state: Dict[str, np.ndarray]   # final state (numpy)
    stats: NetStats
    series: np.ndarray             # (rounds, len(SERIES_FIELDS)) int64
    snapshot: Optional[Dict[str, np.ndarray]] = None  # state after snap round
    device: str = "cpu"

    @property
    def delivered_app(self) -> np.ndarray:
        return self.delivered[:, : self.scenario.m_app]

    def delivered_frac(self) -> float:
        """Fraction of (correct process, app message) pairs delivered."""
        ok = ~self.state["crashed"]
        d = self.delivered_app[ok]
        return float((d >= 0).mean()) if d.size else 1.0

    def mean_latency(self) -> float:
        """Mean rounds from broadcast to delivery over delivered pairs."""
        d = self.delivered_app
        got = d >= 0
        if not got.any():
            return float("nan")
        lat = d - self.scenario.bcast_round[None, :]
        return float(lat[got].mean())


def init_topo_state(scn: VecScenario, width: int) -> Dict[str, np.ndarray]:
    """Topology/gating state plus a ``width``-column message buffer, as
    host arrays (:func:`state_to_device` moves them; the engines start
    from :func:`init_device_state`)."""
    n, k = scn.n, scn.k
    return dict(
        arr=np.full((n, width), INF, np.int32),
        delivered=np.full((n, width), -1, np.int32),
        adj=scn.adj0.astype(np.int32).copy(),
        delay=scn.delay0.astype(np.int32).copy(),
        active=(scn.adj0 >= 0).copy(),
        gate=np.full((n, k), -1, np.int32),
        flush=np.full((n, k), INF, np.int32),
        ping=np.full((n, k), -1, np.int32),
        crashed=np.zeros(n, bool),
        ever_del=np.zeros(n, bool),
    )


def init_device_state(scn: VecScenario, width: int, device: torch.device,
                      rec=NULL_RECORDER) -> Dict[str, torch.Tensor]:
    """The state of :func:`init_topo_state` on ``device``, without a host
    array of plane size: the ``(N, K)`` and ``(N,)`` tables are built on
    the host and uploaded, a ``copy.h2d`` span of ``rec`` each, and the
    two ``(N, width)`` planes, constant at the start, are filled on
    ``device``."""
    tables = init_topo_state(scn, 0)
    planes = dict(arr=_INF, delivered=-1)
    return {key: (torch.full((scn.n, width), planes[key], dtype=torch.int32,
                             device=device) if key in planes
                  else to_device(tables[key], device, rec))
            for key in STATE_KEYS}


def stats_from_series(series: np.ndarray, first_receipts: int) -> NetStats:
    tot = series.sum(axis=0)
    deliveries, sent_app, sent_ping, flush_sent, pongs, _ = (
        int(x) for x in tot)
    sent = sent_app + sent_ping + flush_sent
    return NetStats(
        sent_messages=sent,
        sent_control=sent_ping + pongs,
        control_bytes=_CTRL_APP * (sent_app + flush_sent)
        + _CTRL_PING * sent_ping,
        oob_messages=pongs,
        deliveries=deliveries,
        duplicate_receipts=max(0, sent - first_receipts),
    )


def to_device(a: np.ndarray, device: torch.device,
              rec=NULL_RECORDER) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``, in a ``copy.h2d``
    span of ``rec``: on the card a copy from pageable memory, after
    which PyTorch synchronises the stream."""
    rec.begin(rec.name("copy.h2d"))
    x = torch.from_numpy(a).to(device)
    rec.end()
    return x


def host(x: torch.Tensor, rec=NULL_RECORDER) -> np.ndarray:
    """A host numpy copy of ``x`` (never a view of device state), in a
    ``copy.d2h`` span of ``rec``: from the card it waits for the
    stream."""
    rec.begin(rec.name("copy.d2h"))
    out = x.to("cpu", copy=True).numpy()
    rec.end()
    return out


def state_to_device(st: Dict[str, np.ndarray], device: torch.device,
                    rec=NULL_RECORDER) -> Dict[str, torch.Tensor]:
    return {key: to_device(np.array(st[key]), device, rec)
            for key in STATE_KEYS}


def state_to_host(st: Dict[str, torch.Tensor],
                  rec=NULL_RECORDER) -> Dict[str, np.ndarray]:
    return {key: host(st[key], rec) for key in STATE_KEYS}


# event family -> (round field, event fields in upload-row order)
_FAMILIES = {
    "bc": ("bc_round", ("bc_origin", "bc_slot")),
    "add": ("add_round", ("add_p", "add_k", "add_q", "add_delay",
                          "add_slot")),
    "rm": ("rm_round", ("rm_p", "rm_k")),
    "cr": ("cr_round", ("cr_pid",)),
}


class DeviceSchedule:
    """A :class:`SlotSchedule` uploaded once: each event family becomes
    one round-sorted ``(fields, events)`` int32 tensor, and
    :meth:`events` slices out one round's events by a host-side binary
    search of the sorted rounds, so selecting a round costs the device
    nothing and the host never waits on it.  Each upload is a
    ``copy.h2d`` span of ``rec``."""

    def __init__(self, sched: SlotSchedule, device: torch.device,
                 rec=NULL_RECORDER):
        self.is_app = to_device(np.array(sched.is_app, bool), device, rec)
        self._fam = {}
        for fam, (round_name, names) in _FAMILIES.items():
            rounds = np.asarray(getattr(sched, round_name))
            order = np.argsort(rounds, kind="stable")
            fields = None
            if len(order):
                fields = to_device(np.stack(
                    [np.asarray(getattr(sched, name), np.int32)[order]
                     for name in names]), device, rec)
            self._fam[fam] = (rounds[order], fields)

    def events(self, fam: str, t: int) -> Optional[torch.Tensor]:
        """Round ``t``'s events of family ``fam`` as ``(fields, E_t)``,
        or None when there are none."""
        rounds, fields = self._fam[fam]
        i0, i1 = np.searchsorted(rounds, [t, t + 1])
        return None if i0 == i1 else fields[:, i0:i1]


def apply_events(st: Dict[str, torch.Tensor], ds: DeviceSchedule, t: int,
                 *, pc: bool, always_gate: bool) -> None:
    """Phases 1-4 of round ``t`` in place: removals, additions with the
    Algorithm 2 gating decision, crashes, broadcasts.

    Every write targets distinct cells within a round — same-round
    additions touch distinct processes, broadcasts distinct columns —
    except duplicate removals of one slot, which write equal values, so
    no write depends on the order PyTorch applies it in."""
    delivered = st["delivered"]
    active, gate, flush, ping = (st["active"], st["gate"], st["flush"],
                                 st["ping"])
    crashed = st["crashed"]

    # -- 1. removals ---------------------------------------------------- #
    ev = ds.events("rm", t)
    if ev is not None:
        p, k = ev[0].long(), ev[1].long()
        active[p, k] = False
        gate[p, k] = -1
        flush[p, k] = _INF
        ping[p, k] = -1
    # -- 2. additions (+ Algorithm 2 gating decision) -------------------- #
    ev = ds.events("add", t)
    if ev is not None:
        p, k = ev[0].long(), ev[1].long()
        st["adj"][p, k] = ev[2]
        st["delay"][p, k] = ev[3]
        active[p, k] = True
        gate[p, k] = -1
        flush[p, k] = _INF
        ping[p, k] = -1
        if pc:
            # the new slot itself is safe now, so "another safe slot"
            # means at least two
            other_safe = (active[p] & (gate[p] < 0)).sum(dim=1) >= 2
            want = other_safe & ~crashed[p]
            if not always_gate:
                has_del = st["ever_del"][p] | (
                    (delivered[p] >= 0) & ds.is_app[None, :]).any(dim=1)
                want &= has_del
            slot = ev[4].long()
            gate[p, k] = torch.where(want, t, -1).to(torch.int32)
            ping[p, k] = torch.where(want, ev[4], -1).to(torch.int32)
            # the gating process's own ping floods from phase 8
            delivered[p, slot] = torch.where(want, t, delivered[p, slot])
    # -- 3. crashes (silent; links die with the process) ----------------- #
    ev = ds.events("cr", t)
    if ev is not None:
        crashed[ev[0].long()] = True
    # -- 4. broadcasts --------------------------------------------------- #
    ev = ds.events("bc", t)
    if ev is not None:
        o, s = ev[0].long(), ev[1].long()
        cur = delivered[o, s]
        delivered[o, s] = torch.where(~crashed[o] & (cur < 0), t, cur)


def pong_fire(delivered, adj, gate, flush, ping, crashed) -> torch.Tensor:
    """Phase 6 comparison: which gated links observe their ping
    delivered at the link target this round."""
    n, w = delivered.shape
    q = adj.clamp(0, n - 1).long()
    s = ping.clamp(0, w - 1).long()
    return ((gate >= 0) & (flush == _INF) & (ping >= 0)
            & (delivered[q, s] >= 0) & ~crashed[:, None])


def run_span(st: Dict[str, torch.Tensor], ds: DeviceSchedule, t0: int,
             t1: int, series: torch.Tensor, *, pc: bool, always_gate: bool,
             pong_delay: int, gating: bool) -> None:
    """Advance ``st`` through rounds ``[t0, t1)`` in place, writing each
    round's stats into row ``t - t0`` of the device tensor ``series``.

    ``gating=False`` asserts the *whole scenario* schedules no link
    additions — the only source of gates — so every round takes the
    single fused sweep.  It must not be derived from a windowed
    segment's schedule: a segment without additions can still carry
    gates opened by an earlier one.  With gating under PC-broadcast a
    round splits at the pong boundary, because pong detection must see
    the round's deliveries: deliver sweep, pong gather, flush+forward
    sweep."""
    arr, delivered = st["arr"], st["delivered"]
    adj, delay, active = st["adj"], st["delay"], st["active"]
    gate, flush, ping, crashed = (st["gate"], st["flush"], st["ping"],
                                  st["crashed"])
    is_app = ds.is_app
    zero = torch.zeros((), dtype=torch.int64, device=arr.device)
    for i, t in enumerate(range(t0, t1)):
        apply_events(st, ds, t, pc=pc, always_gate=always_gate)
        alive = ~crashed[:, None]
        if pc and gating:
            # -- 5. deliver sweep ---------------------------------------- #
            _, napp, nping = kx.deliver_sweep(arr, delivered, crashed,
                                              is_app, t)
            # -- 6. pong detection (a cross-column gather) --------------- #
            fire = pong_fire(delivered, adj, gate, flush, ping, crashed)
            flush.masked_fill_(fire, t + pong_delay)
            pongs = fire.sum()
            # -- 7+8. fused flush + forward sweep ------------------------ #
            # A slot flushing this round forwards as safe in the same
            # round (its gate clears between phases 7 and 8), so the
            # forward mask reads the gate as already cleared there.
            flushing = flush == t
            do = flushing & active & alive
            fwd_ok = (active & (gate.masked_fill(flushing, -1) < 0)
                      & (adj >= 0) & alive)
            _, flush_sent = kx.frontier_sweep(arr, delivered, adj, delay,
                                              gate, do, fwd_ok, is_app, t)
            gate.masked_fill_(flushing, -1)
            ping.masked_fill_(flushing, -1)
            flush.masked_fill_(flushing, _INF)
        else:
            # -- 5+8. fused deliver + forward sweep ---------------------- #
            fwd_ok = active & (gate < 0) & (adj >= 0) & alive
            _, _, napp, nping = kx.fused_sweep(arr, delivered, crashed, adj,
                                               delay, fwd_ok, is_app, t)
            pongs = flush_sent = zero
        elig = fwd_ok.sum(dim=1)
        series[i] = torch.stack([napp.sum(), (napp * elig).sum(),
                                 (nping * elig).sum(), flush_sent, pongs,
                                 (gate >= 0).sum()])


def execute_vec(scn: VecScenario, device=None,
                snapshot_round: Optional[int] = None) -> VecRunResult:
    """Execute ``scn`` in lockstep rounds over dense ``(N, M_total)``
    planes; returns the delivery matrix, final state, ``NetStats`` and
    the per-round stats series, all as numpy arrays.  ``snapshot_round``
    additionally captures the full state right after that round.
    ``device`` is the card unless ``"cpu"`` is asked for.

    This is the engine behind ``repro_torch.api.run``; prefer the front
    door (``run(RunSpec(...))``) in new code."""
    dev = resolve_device(device)
    st = init_device_state(scn, scn.m_total, dev)
    ds = DeviceSchedule(full_schedule(scn), dev)
    series = torch.zeros((scn.rounds, len(SERIES_FIELDS)), dtype=torch.int64,
                         device=dev)
    kw = dict(pc=scn.mode == "pc", always_gate=scn.always_gate,
              pong_delay=scn.pong_delay, gating=scn.n_adds > 0)
    snapshot = None
    if snapshot_round is None:
        run_span(st, ds, 0, scn.rounds, series, **kw)
    else:
        cut = snapshot_round + 1
        run_span(st, ds, 0, cut, series[:cut], **kw)
        snapshot = state_to_host(st)
        run_span(st, ds, cut, scn.rounds, series[cut:], **kw)
    first_receipts = int((st["arr"] < scn.rounds).sum())
    final = state_to_host(st)
    series_np = host(series)
    return VecRunResult(scenario=scn, delivered=final["delivered"],
                        state=final,
                        stats=stats_from_series(series_np, first_receipts),
                        series=series_np, snapshot=snapshot, device=str(dev))
