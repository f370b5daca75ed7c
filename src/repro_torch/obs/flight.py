"""Sampled per-message provenance: the flight recorder (the port's copy
of the JAX package's ``repro.obs.flight``).

A deterministic hash sampler selects a subset of application broadcasts
whose full lifecycle is recorded host-side with O(sample) extra state:

    submit -> admit -> activate (broadcast) -> per-receiver delivery
           -> blocked-at rounds -> retire

Every hook fires from the host-side orchestration layer (activation
bookkeeping, retirement sweeps); the only device work it adds is an
``index_select`` of the *sampled* retiring columns of the delivered
plane, so segment bodies are the same with telemetry on or off
(DESIGN.md §2.10/§2.11).

Determinism contract: the sampler keys on ``(seed, origin, key_round)``
where ``key_round`` is the broadcast round in batch mode and the submit
round in live mode (stable across withdraw/requeue), so the sampled set
is a pure function of the scenario, never of the device or the wall
clock.  Records complete in the window's retirement order with
identical payloads on the card, on the CPU and in the JAX package —
the byte-identity the tests pin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "SAMPLERS", "FlightSampler", "FlightRecord", "FlightRecorder",
    "provenance_trace_events", "sample_hash", "sample_all",
]

# --------------------------------------------------------------------- #
# Deterministic samplers
# --------------------------------------------------------------------- #
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wrapping mod 2^64)."""
    z = (x + _GAMMA).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def sample_hash(seed: int, rate: int, origins: np.ndarray,
                rounds: np.ndarray) -> np.ndarray:
    """1-in-``rate`` deterministic selection keyed on (seed, origin, round).

    Two mixing stages so origin and round land in independent lanes; the
    result depends only on the key tuple — not on call order, backend,
    or batch boundaries.
    """
    o = np.asarray(origins, np.uint64)
    r = np.asarray(rounds, np.uint64)
    h = _mix64(_mix64(np.uint64(seed) + o * _GAMMA) + r)
    return (h % np.uint64(max(1, int(rate)))) == 0


def sample_all(seed: int, rate: int, origins: np.ndarray,
               rounds: np.ndarray) -> np.ndarray:
    """Record every application broadcast (tests / tiny runs)."""
    return np.ones(np.asarray(origins).shape, bool)


@dataclass(frozen=True)
class FlightSampler:
    """A named deterministic sampling policy (``--list`` discoverable)."""
    key: str
    sample: Callable[[int, int, np.ndarray, np.ndarray], np.ndarray]
    description: str


SAMPLERS: Dict[str, FlightSampler] = {
    "hash": FlightSampler(
        "hash", sample_hash,
        "1-in-rate splitmix64 hash of (seed, origin, round): "
        "deterministic across backends and shard counts"),
    "all": FlightSampler(
        "all", sample_all,
        "record every application broadcast (rate ignored; "
        "tests and small runs)"),
}


# --------------------------------------------------------------------- #
# Per-message lifecycle records
# --------------------------------------------------------------------- #
@dataclass
class FlightRecord:
    """Full lifecycle of one sampled application broadcast.

    Rounds are simulation rounds; ``-1`` marks "not applicable" (batch
    runs have no submit/admit stage) or "never delivered" in ``deliv``.
    """
    id: int                 # window buffer id (batch: broadcast index)
    origin: int
    bcast_round: int        # round the broadcast enters the network
    submit_round: int = -1  # live: arrival at the front door
    admit_round: int = -1   # live: tick that admitted it into the window
    activate_round: int = -1
    retire_round: int = -1
    expired: bool = False   # horizon-expired rather than fully delivered
    blocked_at: List[int] = field(default_factory=list)
    deliv: Optional[np.ndarray] = None  # (n,) per-receiver delivery round

    def to_dict(self) -> dict:
        return dict(
            id=int(self.id), origin=int(self.origin),
            bcast_round=int(self.bcast_round),
            submit_round=int(self.submit_round),
            admit_round=int(self.admit_round),
            activate_round=int(self.activate_round),
            retire_round=int(self.retire_round),
            expired=bool(self.expired),
            blocked_at=[int(t) for t in self.blocked_at],
            deliv=[int(v) for v in self.deliv]
            if self.deliv is not None else [])


class FlightRecorder:
    """Host-side provenance buffer the engine hooks feed.

    ``open`` maps live window buffer ids to in-flight records;
    ``completed`` accumulates retired records in retirement order (a
    deterministic order: both streaming engines drive one shared
    ``ColumnWindow``).  Withdrawn (backpressure-requeued) columns drop
    their open record — the re-admission recreates it — so a completed
    record always describes the *final* activation.
    """

    def __init__(self, rate: int = 64, seed: int = 0,
                 sampler: str = "hash", auditor=None, live: bool = False):
        if sampler not in SAMPLERS:
            raise KeyError(
                f"unknown sampler {sampler!r}; "
                f"expected one of {sorted(SAMPLERS)}")
        self.rate = max(1, int(rate))
        self.seed = int(seed)
        self.sampler = sampler
        self._fn = SAMPLERS[sampler].sample
        self.auditor = auditor
        self.live = bool(live)
        self.open: Dict[int, FlightRecord] = {}
        self.completed: List[FlightRecord] = []

    # -- sampling ----------------------------------------------------- #
    def want(self, origins: np.ndarray, key_rounds: np.ndarray) -> np.ndarray:
        return self._fn(self.seed, self.rate, origins, key_rounds)

    @property
    def open_count(self) -> int:
        return len(self.open)

    @property
    def sampled(self) -> int:
        return len(self.open) + len(self.completed)

    def sampled_mask(self, ids: np.ndarray) -> np.ndarray:
        """Which of these retiring buffer ids carry an open record."""
        op = self.open
        return np.fromiter((int(i) in op for i in ids), bool, len(ids))

    # -- lifecycle hooks (host side only) ----------------------------- #
    def on_admit(self, ids, origins, submit_rounds, bcast_rounds,
                 admit_round: int) -> None:
        """Live front door: sample on (origin, submit_round)."""
        m = self.want(np.asarray(origins), np.asarray(submit_rounds))
        for j in np.nonzero(m)[0]:
            i = int(ids[j])
            self.open[i] = FlightRecord(
                id=i, origin=int(origins[j]),
                bcast_round=int(bcast_rounds[j]),
                submit_round=int(submit_rounds[j]),
                admit_round=int(admit_round))

    def on_withdraw(self, ids) -> None:
        """Backpressure un-admitted these ids; drop their open records
        so the eventual re-admission records the final placement."""
        for i in ids:
            self.open.pop(int(i), None)

    def on_activate(self, ids, origins, rounds) -> None:
        """Broadcast columns [b0, b1) just went live in the window."""
        if self.live:
            for j, i in enumerate(ids):
                rec = self.open.get(int(i))
                if rec is not None:
                    rec.activate_round = int(rounds[j])
                    rec.bcast_round = int(rounds[j])
            return
        # batch: sample on (origin, broadcast round) at activation
        o = np.asarray(origins)
        r = np.asarray(rounds)
        m = self.want(o, r)
        for j in np.nonzero(m)[0]:
            i = int(ids[j])
            self.open[i] = FlightRecord(
                id=i, origin=int(o[j]), bcast_round=int(r[j]),
                activate_round=int(r[j]))

    def on_blocked(self, ids, t_now: int) -> None:
        """These live sampled columns were gate-blocked at round t_now."""
        for i in ids:
            rec = self.open.get(int(i))
            if rec is not None:
                rec.blocked_at.append(int(t_now))

    def on_retire(self, ids, deliv, t_now: int, by_expiry) -> None:
        """Retirement sweep: ``deliv`` is (n, len(ids)) per-receiver
        delivery rounds gathered from the intact delivered plane."""
        d = np.asarray(deliv)
        for j, i in enumerate(ids):
            rec = self.open.pop(int(i), None)
            if rec is None:       # defensive: unsampled id slipped in
                continue
            rec.retire_round = int(t_now)
            rec.expired = bool(by_expiry[j])
            rec.deliv = np.array(d[:, j], np.int64, copy=True)
            self.completed.append(rec)
            if self.auditor is not None:
                self.auditor.observe(rec)

    # -- export ------------------------------------------------------- #
    def export(self) -> List[dict]:
        return [rec.to_dict() for rec in self.completed]


# --------------------------------------------------------------------- #
# Perfetto export: one track per sampled message
# --------------------------------------------------------------------- #
def provenance_trace_events(records: List[dict], n_devices: int = 1,
                            pid: int = 2,
                            us_per_round: float = 1000.0) -> List[dict]:
    """Chrome trace events on a synthetic round-based timeline.

    Each sampled message gets its own named thread track carrying its
    lifecycle: a ``life`` span submit/broadcast -> retire, a ``queued``
    span for the live front-door wait, per-shard ``deliver`` spans
    covering [min, max] delivery round on that shard's rows, and
    ``blocked`` instants.  1 round = ``us_per_round`` microseconds.
    """
    ev: List[dict] = [dict(
        ph="M", pid=pid, tid=0, name="process_name",
        args=dict(name="provenance (sampled messages)"))]

    def us(r) -> float:
        return float(r) * us_per_round

    for tno, rec in enumerate(records):
        tid = tno + 1
        start = rec["submit_round"] if rec["submit_round"] >= 0 \
            else rec["bcast_round"]
        end = max(rec["retire_round"], start)
        ev.append(dict(ph="M", pid=pid, tid=tid, name="thread_name",
                       args=dict(name=f"msg {rec['id']} "
                                      f"@o{rec['origin']}")))
        ev.append(dict(
            ph="X", pid=pid, tid=tid, ts=us(start),
            dur=max(us(end - start), 1.0),
            name=("life (expired)" if rec["expired"] else "life"),
            args=dict(id=rec["id"], origin=rec["origin"],
                      bcast_round=rec["bcast_round"],
                      retire_round=rec["retire_round"])))
        if rec["submit_round"] >= 0:
            ev.append(dict(
                ph="X", pid=pid, tid=tid, ts=us(rec["submit_round"]),
                dur=max(us(rec["bcast_round"] - rec["submit_round"]), 1.0),
                name="queued",
                args=dict(admit_round=rec["admit_round"])))
        deliv = np.asarray(rec["deliv"], np.int64)
        n = len(deliv)
        d = max(1, int(n_devices))
        rows_per = -(-n // d) if n else 0      # ceil, matches pad_rows
        for s in range(d):
            part = deliv[s * rows_per:(s + 1) * rows_per]
            part = part[part >= 0]
            if not len(part):
                continue
            lo, hi = int(part.min()), int(part.max())
            ev.append(dict(
                ph="X", pid=pid, tid=tid, ts=us(lo),
                dur=max(us(hi - lo), 1.0),
                name=f"deliver shard{s}" if d > 1 else "deliver",
                args=dict(receivers=int(len(part)), first=lo, last=hi)))
        for t in rec["blocked_at"]:
            ev.append(dict(ph="i", pid=pid, tid=tid, ts=us(t), s="t",
                           name="blocked"))
    return ev
