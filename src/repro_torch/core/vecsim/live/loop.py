"""The live serving loop: open-loop ingest -> micro-batch -> segment —
the port's copy of the JAX package's ``repro.core.vecsim.live.loop``,
serving through the windowed or the sharded engine on the card (or the
CPU).

``LiveLoop`` turns a streaming engine into a long-running service. A
pre-drawn open-loop submission trace (``arrivals``) feeds a bounded
ingest queue; each *tick* the loop

1. **ingests** every submission whose round has passed into the queue
   (tail-dropping into ``shed_queue`` when the queue is full),
2. **rolls back** any admitted-but-unactivated broadcasts left by a
   shortened segment (they re-queue at the front, keeping the admitted
   schedule's sorted invariant trivially true),
3. **admits** a batch via the :class:`AdmissionPolicy` — placed into
   the segment's rounds round-robin, at most ``per_round_cap`` per
   round and one per (origin, round) — and appends it to the
   :class:`LiveColumnWindow`,
4. **advances** the engine one segment (``stepper.advance()``).  If the
   window overflows (the capacity-blind ``admit`` policy), the raise is
   state-clean: the loop withdraws the unactivated admissions, requeues
   them, counts an ``overflow_catch`` and retries the same segment —
   backpressure instead of a crash,
5. **accounts**: queue depth, shed/admit counters, and (implicitly, via
   the engine's retirement aggregates) per-message delivery rounds.

The loop stops once every offered submission is admitted or shed, the
queue is drained, all pre-scripted dynamics events have fired and no
column is live — or at the precomputed round ``bound`` (generous:
arrival span + churn span + delivery settle + a drain allowance),
whichever comes first.

Determinism contract: the finally-admitted schedule *is* a
:class:`VecScenario` (``LiveReport.scenario``), and replaying it
through the same engine pre-scripted reproduces the live run's
delivered matrix, per-round series and stats byte-for-byte — the live
loop only ever chooses *what* enters the schedule, never how the
engine executes it.  ``tests/test_torch_live.py`` asserts this, and
that the port's live runs equal the JAX package's byte for byte.

Latency is **rounds-to-delivery**: per message, mean delivery round
(``deliv_round_sum / deliv_count``) minus the *submission* round — so
queueing/deferral delay counts, which is what makes p99 an SLO rather
than a protocol property.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional

import numpy as np

from ....obs.hist import percentiles_from_hist
from ....obs.spans import EngineObs
from ..scenario import VecScenario, settle_rounds
from ..sim import stats_from_series
from ..stream import (WindowedRunResult, WindowedStepper,
                      WindowOverflowError)
from .admission import _ADMISSION, AdmissionPolicy
from .arrivals import build_arrivals
from .window import LiveColumnWindow

__all__ = ["LiveReport", "LiveLoop", "default_per_round_cap",
           "serving_bound"]


def default_per_round_cap(n: int, rate: float) -> int:
    """Default per-round admission cap: comfortable headroom over the
    mean offered rate (bursts drain within a few rounds), bounded by
    the one-broadcast-per-(origin, round) engine invariant."""
    return int(min(n, max(4, int(np.ceil(3.0 * rate)) )))


def serving_bound(scn: VecScenario, window: int, seg_len: int,
                  per_round_cap: int, messages: int,
                  last_arrival: int) -> int:
    """A generous round bound for a live run: the arrival span, any
    pre-scripted dynamics, protocol settle time, and a drain allowance
    sized for the worst case where the window throttles admission to a
    fraction of its columns per segment."""
    max_delay = int(max(scn.delay0.max(initial=1),
                        scn.add_delay.max(initial=1)))
    settle = settle_rounds(scn.n, scn.k, max_delay, scn.pong_delay)
    per_seg = max(1, min(window // 2 + 1, per_round_cap * seg_len))
    drain = seg_len * (4 + 2 * int(np.ceil(messages / per_seg)))
    return int(max(scn.rounds, last_arrival + 2 + settle + drain))


@dataclass
class LiveReport:
    """What a live run measured, plus everything needed to audit it.

    ``scenario`` is the finally-admitted schedule as a pre-scripted
    :class:`VecScenario`; ``result`` is the engine result re-indexed to
    it (admitted ids dense in ``[0, admitted)``), so every batch-mode
    metric/oracle works on it unchanged."""

    offered: int                 # submissions generated by the process
    admitted: int                # entered the engine schedule
    shed_queue: int              # dropped at the full ingest queue
    shed_policy: int             # dropped by a shedding admission policy
    unserved: int                # still queued when the bound hit
    rounds: int                  # final engine round (simulated)
    bound: int                   # the round ceiling the loop ran under
    ticks_run: int
    wall_seconds: float
    requests_per_sec: float      # admitted / wall (sustained capacity)
    p50: float                   # rounds-to-delivery percentiles over
    p99: float                   # delivered admitted messages,
    p999: float                  # queueing delay included
    mean_latency_rounds: float
    queue_peak: int
    backpressure_ticks: int      # ticks where capacity clamped the plan
    overflow_catches: int        # WindowOverflowError caught + deferred
    peak_live: int
    delivered_messages: int      # admitted messages with >= 1 delivery
    delivered_frac: float
    slo_p99: Optional[float]
    slo_ok: Optional[bool]
    scenario: VecScenario = field(repr=False)
    result: WindowedRunResult = field(repr=False)
    latency_rounds: np.ndarray = field(repr=False)   # per delivered msg
    submit_round: np.ndarray = field(repr=False)     # per admitted msg
    ticks: List[dict] = field(repr=False, default_factory=list)

    def to_dict(self) -> dict:
        """JSON-safe summary (arrays and heavyweight members dropped)."""
        out = {}
        for key in ("offered", "admitted", "shed_queue", "shed_policy",
                    "unserved", "rounds", "bound", "ticks_run",
                    "wall_seconds", "requests_per_sec", "p50", "p99",
                    "p999", "mean_latency_rounds", "queue_peak",
                    "backpressure_ticks", "overflow_catches", "peak_live",
                    "delivered_messages", "delivered_frac", "slo_p99",
                    "slo_ok"):
            v = getattr(self, key)
            if isinstance(v, float) and not np.isfinite(v):
                v = None
            out[key] = v
        return out


class LiveLoop:
    """Open-loop serving of causal broadcast through a stepped engine.

    ``scn`` is a broadcast-free base scenario (topology + optional
    pre-scripted churn/crash dynamics); its ``rounds`` is raised to the
    serving bound internally.  ``engine`` is ``"windowed"`` or
    ``"sharded"`` (over ``devices`` ranks, with the ``scan`` and
    ``profile`` knobs; every rank runs the same loop); ``device`` is the
    card unless ``"cpu"`` is asked for; everything else mirrors the
    batch-mode engine knobs plus the serving-specific ones documented on
    :class:`repro_torch.api.LiveSpec`.
    """

    def __init__(self, scn: VecScenario, window: int, *,
                 engine: str = "windowed", device=None,
                 devices: Optional[int] = None, scan: str = "auto",
                 profile: bool = False, seg_len: int = 32, horizon: Optional[int] = None,
                 collect: str = "auto",
                 arrivals: str = "poisson", admission: str = "defer",
                 rate: float = 8.0, messages: int = 1024,
                 queue_cap: int = 4096,
                 per_round_cap: Optional[int] = None,
                 slo_p99: Optional[float] = None,
                 seed: int = 0,
                 arrival_params: Optional[dict] = None,
                 obs: Optional[EngineObs] = None,
                 on_tick: Optional[Callable[[dict], None]] = None,
                 ops=None):
        if scn.m_app:
            raise ValueError("live mode needs a broadcast-free base "
                             "scenario; traffic comes from `arrivals`")
        if engine not in ("windowed", "sharded"):
            raise ValueError(f"live mode supports engine='windowed' or "
                             f"'sharded', got {engine!r}")
        try:
            self.policy: AdmissionPolicy = _ADMISSION[admission]
        except KeyError:
            raise KeyError(f"unknown admission policy {admission!r}; "
                           f"known: {sorted(_ADMISSION)}") from None
        self.arr_round, self.arr_origin = build_arrivals(
            arrivals, seed, scn.n, rate, messages,
            **(arrival_params or {}))
        self.offered = int(messages)
        self.prc = (default_per_round_cap(scn.n, rate)
                    if per_round_cap is None else int(per_round_cap))
        if self.prc < 1 or self.prc > scn.n:
            raise ValueError(
                f"per_round_cap must be in [1, n={scn.n}], got {self.prc}")
        self.seg_len = seg_len = max(1, int(seg_len))
        self.bound = serving_bound(scn, int(window), seg_len, self.prc,
                                   messages, int(self.arr_round[-1]))
        self.scn = scn = replace(scn, rounds=self.bound)
        # latest pre-scripted event; the loop may not stop before it
        self.dyn_end = int(max(scn.add_round.max(initial=-1),
                               scn.rm_round.max(initial=-1),
                               scn.crash_round.max(initial=-1))) + 1
        self.queue_cap = int(queue_cap)
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        self.slo_p99 = slo_p99
        self.on_tick = on_tick
        # live runs default to histogram telemetry: percentiles in the
        # report come from the merged on-device histogram, and an
        # explicitly disabled one falls back to host np.percentile
        self.obs = EngineObs(histograms=True) if obs is None else obs
        # ops plane (repro.obs.ops): per-tick gauge publisher; flight
        # recorder hooks ride admission/withdrawal (repro.obs.flight)
        self.ops = ops
        self._flight = getattr(self.obs, "flight", None)
        self._rec = rec = self.obs.spans
        self._sid_tick = rec.name("tick")
        self._sid = {name: rec.name(f"tick.{name}")
                     for name in ("ingest", "requeue", "admit", "advance",
                                  "queue")}
        self._sid_bp = rec.name("backpressure")
        self._sid_finish = rec.name("loop.finish")

        rec.begin(rec.name("loop.setup"))
        self.cw = LiveColumnWindow(scn, window, capacity=messages,
                                   horizon=horizon)
        if engine == "sharded":
            from ..shard.driver import ShardedStepper
            self.stepper = ShardedStepper(
                scn, window, n_devices=devices, device=device,
                horizon=horizon, seg_len=seg_len, collect=collect,
                scan=scan, profile=profile, cw=self.cw, obs=self.obs)
        else:
            self.stepper = WindowedStepper(
                scn, window, device=device, horizon=horizon,
                seg_len=seg_len, collect=collect, cw=self.cw, obs=self.obs)
        rec.end()

        self.queue: deque = deque()      # (submit_round, origin)
        self.submit_round = np.full(messages, -1, np.int64)
        # latency counts from *submission*: the engines bucket
        # ``delivery_round - latency_base[msg_id]`` at retirement, so
        # queueing/deferral delay lands in the histogram too
        self.obs.latency_base = self.submit_round
        self.arr_ptr = 0
        self.admitted = 0
        self.shed_queue = 0
        self.shed_policy = 0
        self.requeued = 0
        self.queue_peak = 0
        self.backpressure_ticks = 0
        self.overflow_catches = 0
        self.ticks: List[dict] = []

    # ------------------------------------------------------------- tick

    def _ingest(self, t: int) -> None:
        """Move every submission with round < t into the bounded queue;
        tail-drop into ``shed_queue`` when it is full."""
        hi = int(np.searchsorted(self.arr_round, t))
        while self.arr_ptr < hi:
            if len(self.queue) < self.queue_cap:
                self.queue.append((int(self.arr_round[self.arr_ptr]),
                                   int(self.arr_origin[self.arr_ptr])))
            else:
                self.shed_queue += 1
            self.arr_ptr += 1
        self.queue_peak = max(self.queue_peak, len(self.queue))

    def _requeue_unactivated(self) -> int:
        """Roll back admitted-but-unactivated broadcasts to the front of
        the queue, original submit rounds preserved (their buffer ids
        recycle)."""
        lo = self.cw.next_bc
        if self._flight is not None:
            # withdrawn ids recycle: drop their open provenance so the
            # eventual re-admission records the final activation
            self._flight.on_withdraw(range(lo, self.cw.m_bc))
        rounds, origins = self.cw.withdraw_unactivated()
        k = len(rounds)
        if k:
            subs = self.submit_round[lo: lo + k]
            for s, o in zip(subs[::-1].tolist(), origins[::-1].tolist()):
                self.queue.appendleft((int(s), int(o)))
            self.admitted -= k
            self.requeued += k
        return k

    def _admit(self, t: int, t_end: int) -> int:
        """Plan and append this tick's admissions into rounds
        ``[t, t_end)``."""
        nrounds = t_end - t
        if not self.queue or nrounds <= 0:
            return 0
        want = len(self.queue)
        cap = nrounds * self.prc
        if self.policy.capacity_aware:
            free = int((self.cw.slot_msg < 0).sum())
            adds_due = (int(np.searchsorted(self.cw.add_round_s, t_end))
                        - self.cw.next_add)
            cap = min(cap, max(0, free - adds_due))
        cap = min(cap, self.cw.m_app_cap - self.cw.m_bc)
        k = min(want, cap)
        counts = np.zeros(nrounds, np.int64)
        used = [set() for _ in range(nrounds)]
        batch = []                       # (round, submit_round, origin)
        skipped = []
        while self.queue and len(batch) < k:
            sub, org = self.queue.popleft()
            start = len(batch) % nrounds
            for j in range(nrounds):
                r = (start + j) % nrounds
                if counts[r] < self.prc and org not in used[r]:
                    counts[r] += 1
                    used[r].add(org)
                    batch.append((t + r, sub, org))
                    break
            else:
                # this origin collides in every schedulable round; it
                # keeps its queue position and waits for the next tick
                skipped.append((sub, org))
        for item in reversed(skipped):
            self.queue.appendleft(item)
        if self.policy.drop_excess and self.queue:
            self.shed_policy += len(self.queue)
            self.queue.clear()
        if len(batch) < want:
            self.backpressure_ticks += 1
        if batch:
            batch.sort(key=lambda b: b[0])
            ids = self.cw.append_broadcasts(
                np.array([b[0] for b in batch], np.int32),
                np.array([b[2] for b in batch], np.int32))
            self.submit_round[ids] = [b[1] for b in batch]
            self.admitted += len(batch)
            if self._flight is not None:
                self._flight.on_admit(
                    ids,
                    np.array([b[2] for b in batch], np.int64),
                    np.array([b[1] for b in batch], np.int64),
                    np.array([b[0] for b in batch], np.int64), t)
        return len(batch)

    def _tick(self) -> None:
        rec = self._rec
        rec.begin(self._sid_tick)
        try:
            t = self.stepper.t
            t_end = min(t + self.seg_len, self.bound)
            rec.begin(self._sid["ingest"])
            self._ingest(t)
            rec.end()
            rec.begin(self._sid["requeue"])
            self._requeue_unactivated()
            rec.end()
            rec.begin(self._sid["admit"])
            admitted_now = self._admit(t, t_end)
            rec.end()
            rec.counter(self._sid["queue"], len(self.queue))
            rec.begin(self._sid["advance"])
            try:
                self.stepper.advance()
            except WindowOverflowError as exc:
                # state-clean raise: withdraw what was not activated,
                # defer it, and retry the segment with only the
                # already-live load.  A second raise means even the
                # pre-scripted activations (link pings) cannot fit — a
                # genuine configuration error.
                self.overflow_catches += 1
                self.obs.count("backpressure_events")
                rec.instant(self._sid_bp, float(exc.round))
                self._requeue_unactivated()
                self.stepper.advance()
            finally:
                rec.end()
        finally:
            rec.end()
        info = dict(t=self.stepper.t, admitted=admitted_now,
                    queue=len(self.queue),
                    live=int((self.cw.slot_msg >= 0).sum()),
                    admitted_total=self.admitted,
                    shed=self.shed_queue + self.shed_policy)
        self.ticks.append(info)
        if self.ops is not None:
            self.ops.publish(self, info)
        if self.on_tick is not None:
            self.on_tick(info)

    def _drained(self) -> bool:
        return (self.arr_ptr >= self.offered
                and not self.queue
                and self.cw.next_bc == self.cw.m_bc
                and self.stepper.t >= self.dyn_end
                and not (self.cw.slot_msg >= 0).any())

    # -------------------------------------------------------------- run

    def admitted_scenario(self) -> VecScenario:
        """The finally-admitted schedule as a pre-scripted scenario
        over the rounds the loop actually ran — replaying it batch-mode
        reproduces this live run byte-for-byte."""
        m_bc = self.cw.m_bc
        return replace(
            self.scn, rounds=max(1, int(self.stepper.t)),
            bcast_round=self.cw.bc_round[:m_bc].copy(),
            bcast_origin=self.cw.bc_origin[:m_bc].copy()).validate()

    def _finalize(self, wall: float) -> LiveReport:
        final_t = int(self.stepper.t)
        res = self.stepper.finish()
        adm = self.admitted_scenario()
        m_bc, cap = self.cw.m_bc, self.cw.m_app_cap
        # re-index every per-message aggregate from the capacity id
        # space to the admitted scenario's dense one
        sel = np.concatenate([np.arange(m_bc),
                              cap + np.arange(self.scn.n_adds)])
        res.scenario = adm
        res.deliv_count = res.deliv_count[sel]
        res.deliv_round_sum = res.deliv_round_sum[sel]
        res.expired = res.expired[sel]
        res.bcast_done = res.bcast_done[:m_bc]
        if res.delivered is not None:
            res.delivered = res.delivered[:, sel]
        res.series = res.series[: adm.rounds]
        res.stats = stats_from_series(res.series,
                                      self.stepper.retirer.first_receipts)

        submit = self.submit_round[:m_bc]
        cnt = res.deliv_count[:m_bc]
        got = cnt > 0
        lat = np.empty(0, float)
        if got.any():
            mean_del = (res.deliv_round_sum[:m_bc][got]
                        / cnt[got].astype(float))
            lat = mean_del - submit[got]
        if self.obs.histograms and self.obs.latency_hist.sum() > 0:
            # exact percentiles over *per-delivery* latencies from the
            # histogram (log-bucketed above 16 rounds); without it the
            # path below interpolates over per-message means
            p50, p99, p999 = percentiles_from_hist(
                self.obs.latency_hist, (50.0, 99.0, 99.9))
            mean_lat = float(lat.mean()) if len(lat) else float("nan")
        elif len(lat):
            p50, p99, p999 = (float(x) for x in
                              np.percentile(lat, [50.0, 99.0, 99.9]))
            mean_lat = float(lat.mean())
        else:
            p50 = p99 = p999 = mean_lat = float("nan")
        slo_ok = (None if self.slo_p99 is None
                  else bool(len(lat) and p99 <= self.slo_p99))
        dmsgs = int(got.sum())
        dfrac = float(res.delivered_frac()) if m_bc else 1.0
        return LiveReport(
            offered=self.offered, admitted=self.admitted,
            shed_queue=self.shed_queue, shed_policy=self.shed_policy,
            unserved=len(self.queue) + (self.offered - self.arr_ptr),
            rounds=final_t, bound=self.bound, ticks_run=len(self.ticks),
            wall_seconds=wall,
            requests_per_sec=(self.admitted / wall if wall > 0
                              else float("nan")),
            p50=p50, p99=p99, p999=p999, mean_latency_rounds=mean_lat,
            queue_peak=self.queue_peak,
            backpressure_ticks=self.backpressure_ticks,
            overflow_catches=self.overflow_catches,
            peak_live=res.peak_live, delivered_messages=dmsgs,
            delivered_frac=dfrac, slo_p99=self.slo_p99, slo_ok=slo_ok,
            scenario=adm, result=res, latency_rounds=lat,
            submit_round=submit.copy(), ticks=self.ticks)

    def run(self) -> LiveReport:
        """Serve until drained (or the bound); returns the report."""
        t0 = time.perf_counter()
        try:
            while self.stepper.t < self.bound and not self._drained():
                self._tick()
        finally:
            if self.ops is not None:
                self.ops.close()
        wall = time.perf_counter() - t0
        self._rec.begin(self._sid_finish)
        report = self._finalize(wall)
        self._rec.end()
        return report
