"""``repro_torch.api.run`` — the port's front door, batch and live.

``run(spec)`` resolves every axis of a validated :class:`RunSpec`
through the registries, builds (or accepts) the scenario, picks the
engine, executes on the spec's device, and returns a :class:`RunReport`
whatever ran underneath — the exact event simulator, the monolithic vec
engine, the streaming windowed or sharded engine, or the vectorized
vector-clock baseline — with the telemetry of the spec's ``obs``
section (latency histograms and their percentiles in the extras, spans,
metrics and trace files, provenance and the causality audit).  ``mode="live"`` serves open-loop
traffic through a streaming engine (:class:`LiveLoop`) instead.

Engine auto-selection (the JAX package's DESIGN.md §3.3 rule): with
``engine="auto"``,

  1. an explicit ``window.window`` selects a streaming engine — the
     sharded one when ``shard.devices`` asks for more than one rank,
     the windowed one otherwise;
  2. otherwise the monolithic vec engine runs iff its two dense
     ``(N, M_total)`` int32 planes fit the spec's memory budget
     (``8·N·M_total <= memory_budget_mb``);
  3. otherwise a streaming engine runs with ``window = clamp(D·budget
     // (8·N), 64, M_total)``: the sharded engine over ``D`` ranks when
     ``D > 1``, the windowed engine otherwise.  ``D`` is
     ``shard.devices`` if set, else the running process group's size,
     else the cards ``torch.cuda.device_count()`` shows (1 on the CPU).
     A protocol with no windowed engine (``vc``) always runs on the
     monolithic one.

The exact event engine is never auto-selected — it is the O(objects)
reference implementation, runs Python objects on the host (its report's
``device`` reads ``"object"``) and must be asked for by name.
``metrics.crossval`` replays the scenario on it and compares the
delivered multisets with the vec side's, which runs on the spec's
device.

**Ranks.**  A sharded run over ``D > 1`` ranks with no process group
running starts them itself: ``run`` spawns ``D`` processes
(``torch.multiprocessing``), NCCL with one card a rank on the card or
gloo on the CPU, each of which runs the same spec; rank 0's report is
returned, only rank 0 writes the telemetry files, and a failure on any
rank raises here.  ``on_tick`` is not called from spawned ranks.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import resolve_device
from ..core.oracle import OracleReport, check_trace
from ..core.types import NetStats
from ..core.vecsim import crossval as _crossval
from ..core.vecsim.live import LiveLoop, LiveReport
from ..core.vecsim.metrics import build_trace
from ..core.vecsim.scenario import VecScenario
from ..core.vecsim.shard import execute_sharded
from ..core.vecsim.shard.mesh import require_cards
from ..core.vecsim.sim import execute_vec
from ..core.vecsim.stream import execute_windowed
from ..core.vecsim.vc import run_vec_vc
from ..obs.audit import CausalAuditor
from ..obs.flight import FlightRecorder, provenance_trace_events
from ..obs.graphs import overhead_per_message
from ..obs.hist import percentiles_from_hist
from ..obs.ops import OpsPlane
from ..obs.sinks import write_chrome_trace
from ..obs.spans import EngineObs
from .registry import ENGINES, PROTOCOLS, SCENARIOS, SINKS, EngineEntry
from .spec import RunSpec, SpecError

__all__ = ["RunReport", "run", "build_scenario", "select_engine",
           "build_live_scenario"]


@dataclass
class RunReport:
    """Uniform result of :func:`run`, whatever engine executed."""

    spec: RunSpec
    engine: str                # engine that actually ran
    device: str                # torch device the engine ran on
    #                            ("object" for the exact engine)
    window: Optional[int]      # live columns (streaming engines only)
    wall_seconds: float
    n: int
    m_app: int
    rounds: int
    stats: NetStats
    delivered_frac: float
    mean_latency: float        # rounds (vec) / sim-time units (exact)
    extras: Dict[str, float] = field(default_factory=dict)
    oracle: Optional[OracleReport] = None
    crossval_ok: Optional[bool] = None
    result: Any = None         # the raw engine result object
    scenario: Any = None       # the VecScenario that ran
    live: Optional[LiveReport] = None   # serving report (mode="live")
    obs: Any = None            # EngineObs telemetry accumulator (or None)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe summary (drops the raw result and scenario)."""
        try:
            spec_d = self.spec.to_dict()
        except SpecError:
            spec_d = {"scenario": "prebuilt"}
        return dict(
            spec=spec_d, engine=self.engine, device=self.device,
            window=self.window, wall_seconds=round(self.wall_seconds, 4),
            n=self.n, m_app=self.m_app, rounds=self.rounds,
            stats=vars(self.stats).copy(),
            delivered_frac=self.delivered_frac,
            mean_latency=self.mean_latency,
            extras={k: (v if isinstance(v, (int, str)) else float(v))
                    for k, v in self.extras.items()},
            oracle_ok=None if self.oracle is None else self.oracle.ok,
            crossval_ok=self.crossval_ok,
            live=None if self.live is None else self.live.to_dict(),
        )


# --------------------------------------------------------------------- #
# Scenario construction and engine selection
# --------------------------------------------------------------------- #
def build_scenario(spec: RunSpec) -> VecScenario:
    """Resolve the spec's topology/traffic/dynamics sections into a
    :class:`VecScenario` (or pass through a prebuilt one)."""
    if spec.scenario is not None:
        scn = spec.scenario
    else:
        scn = SCENARIOS.get(spec.dynamics.kind).build(spec)
    proto = PROTOCOLS.get(spec.protocol)
    want_mode = proto.mode if proto.mode is not None else scn.mode
    if scn.mode != want_mode or scn.always_gate != spec.always_gate:
        scn = replace(scn, mode=want_mode,
                      always_gate=spec.always_gate).validate()
    return scn


def _auto_window(spec: RunSpec, scn: VecScenario, devices: int = 1) -> int:
    """The budget-derived window: ``clamp(D·budget // (8·N), 64,
    M_total)`` live columns — the budget reads per rank, so ``D`` ranks
    scale the window with them."""
    budget = devices * spec.memory_budget_mb * 2 ** 20
    return int(min(max(64, budget // (8 * scn.n)), scn.m_total))


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _in_group() else 0


def _device_count(spec: RunSpec) -> int:
    """Ranks a sharded run would use: ``shard.devices`` if set, else the
    running process group's size, else the cards the card route sees
    (1 on the CPU route)."""
    if spec.shard.devices is not None:
        return spec.shard.devices
    if _in_group():
        return dist.get_world_size()
    if spec.device == "cpu":
        return 1
    return torch.cuda.device_count()


def select_engine(spec: RunSpec, scn: VecScenario
                  ) -> Tuple[str, Optional[int]]:
    """Apply the auto-selection rule; explicit engines pass through
    unchanged (with the spec's window, if any)."""
    if spec.engine != "auto":
        return spec.engine, spec.window.window
    if spec.window.window is not None:
        if (spec.shard.devices or 1) > 1:
            return "sharded", spec.window.window
        return "windowed", spec.window.window
    if 8 * scn.n * max(scn.m_total, 1) <= spec.memory_budget_mb * 2 ** 20 \
            or not PROTOCOLS.get(spec.protocol).windowed:
        return "vec", None
    devices = _device_count(spec)
    if devices > 1:
        return "sharded", _auto_window(spec, scn, devices=devices)
    return "windowed", _auto_window(spec, scn)


def _snapshot_round(spec: RunSpec, scn: VecScenario) -> Optional[int]:
    snap = spec.metrics.snapshot
    if snap == "last_churn":
        return int(scn.add_round[-1]) if scn.n_adds else None
    return snap


# --------------------------------------------------------------------- #
# Engine adapters (registered under repro_torch.api.ENGINES)
# --------------------------------------------------------------------- #
def _latency_from_trace(trace) -> float:
    t_bcast: Dict[Tuple[int, int], float] = {}
    lat_sum, lat_cnt = 0.0, 0
    for t, kind, pid, m in trace:
        if kind not in ("broadcast", "deliver"):
            continue                      # open/close/crash carry no AppMsg
        key = (m.origin, m.counter)
        if kind == "broadcast":
            t_bcast[key] = t
        elif key in t_bcast:
            lat_sum += t - t_bcast[key]
            lat_cnt += 1
    return lat_sum / lat_cnt if lat_cnt else float("nan")


def _run_exact(spec: RunSpec, scn: VecScenario, window: Optional[int],
               snapshot_round: Optional[int], device, obs=None):
    net = _crossval.run_exact(scn, seed=spec.seed, protocol=spec.protocol,
                              snapshot_round=snapshot_round)
    n_bcast = sum(1 for _, kind, _, _ in net.trace if kind == "broadcast")
    alive = sum(1 for p in net.procs.values() if not p.crashed)
    frac = (net.stats.deliveries / (alive * n_bcast)
            if alive * n_bcast else 1.0)
    extras: Dict[str, float] = {
        "overhead_bytes_per_msg": overhead_per_message(net)}
    if spec.protocol == "vc":
        comparisons = sum(p.comparisons for p in net.procs.values())
        extras["comparisons_per_delivery"] = (
            comparisons / max(net.stats.deliveries, 1))
        extras["max_pending"] = max(p.max_pending
                                    for p in net.procs.values())
        extras["space_entries_max"] = max(p.local_space_entries()
                                          for p in net.procs.values())
    return net, net.stats, frac, _latency_from_trace(net.trace), extras


def _vec_extras(spec: RunSpec, res) -> Dict[str, float]:
    if spec.protocol == "vc":
        return {
            "overhead_bytes_per_msg": res.overhead_bytes_per_message(),
            "comparisons_per_delivery": res.comparisons_per_delivery(),
            "max_pending": res.max_pending,
            "space_entries_max": int((res.vc > 0).sum(axis=1).max()),
        }
    return {
        "overhead_bytes_per_msg": res.stats.control_bytes
        / max(res.stats.sent_messages, 1),
        "gated_link_rounds": int(res.series[:, 5].sum()),
        "pongs": int(res.series[:, 4].sum()),
    }


def _run_vec(spec: RunSpec, scn: VecScenario, window: Optional[int],
             snapshot_round: Optional[int], device, obs=None):
    if spec.protocol == "vc":
        if snapshot_round is not None:
            raise SpecError("metrics.snapshot is not supported for the "
                            "'vc' protocol (it has no gating state to "
                            "snapshot)")
        res = run_vec_vc(scn, device=device)
    else:
        res = execute_vec(scn, device=device, snapshot_round=snapshot_round)
    return (res, res.stats, res.delivered_frac(), res.mean_latency(),
            _vec_extras(spec, res))


def _run_windowed(spec: RunSpec, scn: VecScenario, window: Optional[int],
                  snapshot_round: Optional[int], device, obs=None):
    if window is None:
        # explicit engine="windowed" without a window: the budget rule
        window = _auto_window(spec, scn)
    res = execute_windowed(
        scn, window, device=device, horizon=spec.window.horizon,
        seg_len=spec.window.seg_len, snapshot_round=snapshot_round,
        collect=spec.window.collect, obs=obs)
    extras = _vec_extras(spec, res)
    extras["peak_live"] = res.peak_live
    extras["expired_columns"] = int(res.expired.sum())
    return (res, res.stats, res.delivered_frac(), res.mean_latency(),
            extras)


def _run_sharded(spec: RunSpec, scn: VecScenario, window: Optional[int],
                 snapshot_round: Optional[int], device, obs=None):
    if spec.protocol == "vc":
        raise SpecError("protocol 'vc' has no sharded engine (its "
                        "delivery drain is a data-dependent fixpoint); "
                        "use engine='vec'")
    if window is None:
        # explicit engine="sharded" without a window: the per-rank
        # budget rule over the ranks the run uses
        window = _auto_window(spec, scn, devices=_device_count(spec))
    res = execute_sharded(
        scn, window, n_devices=spec.shard.devices, device=device,
        horizon=spec.window.horizon, seg_len=spec.window.seg_len,
        snapshot_round=snapshot_round, collect=spec.window.collect,
        scan=spec.shard.scan, profile=spec.shard.profile, obs=obs)
    extras = _vec_extras(spec, res)
    extras["peak_live"] = res.peak_live
    extras["expired_columns"] = int(res.expired.sum())
    extras["devices"] = res.n_devices
    extras["scan"] = res.scan
    if res.seg_profile is not None:
        # scalar totals; the per-segment list stays on the raw result
        for key in ("stage_s", "dispatch_s", "block_s", "retire_s"):
            extras["profile_" + key] = float(
                sum(p[key] for p in res.seg_profile))
        extras["profile_segments"] = len(res.seg_profile)
        extras["profile_fast_segments"] = res.fast_segments
    return (res, res.stats, res.delivered_frac(), res.mean_latency(),
            extras)


ENGINES.register("exact", EngineEntry(
    "exact", "O(objects) discrete-event reference simulator on the host "
    "(never auto-selected; paper-faithful sub-round timing)", _run_exact))
ENGINES.register("vec", EngineEntry(
    "vec", "monolithic vectorized lockstep engine: dense (N, M_total) "
    "planes on the device", _run_vec))
ENGINES.register("windowed", EngineEntry(
    "windowed", "streaming windowed engine: O(N*window) live-column "
    "planes kept on the device for sustained traffic", _run_windowed))
ENGINES.register("sharded", EngineEntry(
    "sharded", "sharded windowed engine: process rows split over "
    "torch.distributed ranks (ring frontier exchange), one card a rank; "
    "shard.scan=auto|on|off picks the deferred/fast segment loop or "
    "per-round stepping, shard.profile=True records per-segment times",
    _run_sharded))


# --------------------------------------------------------------------- #
# Telemetry plumbing (repro_torch.obs)
# --------------------------------------------------------------------- #
def _build_obs(spec: RunSpec, engine_name: str,
               live: bool = False) -> Optional[EngineObs]:
    """The :class:`EngineObs` accumulator a run threads through its
    engine, or None when every telemetry pillar is off."""
    ob = spec.obs
    hist = ob.histograms
    if hist is None:
        # auto: on wherever an engine can feed it (the streaming
        # engines' retirement sweeps, and every live run)
        hist = live or engine_name in ("windowed", "sharded")
    spans = bool(ob.spans or ob.trace_out is not None)
    flight = None
    if ob.provenance is not None:
        if not live and engine_name not in ("windowed", "sharded"):
            raise SpecError(
                f"obs.provenance needs a streaming engine (the hooks "
                f"ride column retirement), but this run resolved to "
                f"engine={engine_name!r}; set an explicit window or "
                "engine='windowed'/'sharded'")
        auditor = (CausalAuditor(ob.audit) if ob.audit != "off"
                   else None)
        flight = FlightRecorder(rate=ob.provenance, seed=spec.seed,
                                sampler=ob.sampler, auditor=auditor,
                                live=live)
    if not live and not hist and not spans and ob.metrics_out is None \
            and flight is None:
        return None
    obs = EngineObs(histograms=hist, spans=spans,
                    span_capacity=ob.span_capacity)
    obs.flight = flight
    return obs


def _obs_extras(obs: Optional[EngineObs], extras: Dict[str, float]) -> None:
    """Histogram-derived latency percentiles and telemetry counters into
    the report extras."""
    if obs is None:
        return
    total = int(obs.latency_hist.sum())
    if obs.histograms and total > 0:
        p50, p99, p999 = percentiles_from_hist(
            obs.latency_hist, (50.0, 99.0, 99.9))
        extras["latency_p50"] = p50
        extras["latency_p99"] = p99
        extras["latency_p999"] = p999
        extras["latency_hist_total"] = total
    fl = obs.flight
    if fl is not None:
        extras["provenance_sampled"] = fl.sampled
        if fl.auditor is not None:
            extras["audit_pairs_checked"] = fl.auditor.pairs_checked
            extras["audit_violations"] = len(fl.auditor.violations)
    for name, value in obs.counters.items():
        extras[name] = value


def _metrics_doc(spec: RunSpec, report: "RunReport",
                 obs: EngineObs) -> dict:
    """The sink-agnostic telemetry doc a metrics sink serializes (the
    JAX package's, with ``device`` in the place of ``backend``)."""
    fl = obs.flight
    run = dict(engine=report.engine, device=report.device,
               mode=spec.mode, protocol=spec.protocol, n=report.n,
               m_app=report.m_app, rounds=report.rounds,
               seed=spec.seed)
    if "devices" in report.extras:
        run["devices"] = int(report.extras["devices"])
    return dict(
        run=run,
        summary=dict(
            wall_seconds=report.wall_seconds,
            delivered_frac=report.delivered_frac,
            mean_latency=report.mean_latency,
            **{k: v for k, v in report.extras.items()
               if isinstance(v, (int, float))}),
        gauges={k: list(v) for k, v in obs.gauges.items()},
        counters=dict(obs.counters),
        latency_hist=(obs.latency_hist
                      if obs.histograms and obs.latency_hist.sum() > 0
                      else None),
        provenance=(fl.export() if fl is not None else None))


def _write_obs_outputs(spec: RunSpec, report: "RunReport") -> None:
    ob, obs = spec.obs, report.obs
    if obs is None or _rank() != 0:
        return
    if ob.metrics_out is not None:
        SINKS.get(ob.sink).write(ob.metrics_out,
                                 _metrics_doc(spec, report, obs))
    if ob.trace_out is not None:
        try:
            run_args = spec.to_dict()
        except SpecError:
            run_args = {"scenario": "prebuilt"}
        extra = None
        fl = obs.flight
        if fl is not None and fl.completed:
            extra = provenance_trace_events(fl.export())
        write_chrome_trace(ob.trace_out, obs.spans, run_args=run_args,
                           extra_events=extra)


# --------------------------------------------------------------------- #
# Live serving mode
# --------------------------------------------------------------------- #
def build_live_scenario(spec: RunSpec) -> VecScenario:
    """The broadcast-free base a live run serves over: the spec's
    topology and dynamics with every pre-scripted broadcast stripped
    (live traffic arrives through the ingest queue instead)."""
    scn = build_scenario(spec)
    if scn.m_app:
        scn = replace(scn, bcast_round=np.empty(0, np.int32),
                      bcast_origin=np.empty(0, np.int32)).validate()
    return scn


def _select_live_engine(spec: RunSpec, scn: VecScenario
                        ) -> Tuple[str, int]:
    """Streaming-engine selection for live mode: the explicit engine if
    named, else sharded over several ranks, windowed otherwise; the
    window follows the batch budget rule with ``M_total`` read from the
    serving capacity (``live.messages`` + pre-scripted adds)."""
    if spec.engine in ("windowed", "sharded"):
        name = spec.engine
    else:
        name = "sharded" if _device_count(spec) > 1 else "windowed"
    window = spec.window.window
    if window is None:
        devices = _device_count(spec) if name == "sharded" else 1
        budget = devices * spec.memory_budget_mb * 2 ** 20
        m_total = spec.live.messages + scn.n_adds
        window = int(min(max(64, budget // (8 * scn.n)), max(m_total, 1)))
    return name, window


def _run_live(spec: RunSpec, device, scn: VecScenario, engine_name: str,
              window: int, on_tick=None) -> RunReport:
    obs = _build_obs(spec, engine_name, live=True)
    lv = spec.live
    arrival_params = dict(rate_lo=lv.rate_lo, period=lv.period,
                          duty=lv.duty)
    ob = spec.obs
    ops = None
    if (ob.ops_out is not None or ob.watch) and _rank() == 0:
        ops = OpsPlane(out=ob.ops_out, sink=ob.ops_sink,
                       every=ob.ops_every, slo_p99=lv.slo_p99,
                       watch=True if ob.watch else None)
    loop = LiveLoop(
        scn, window, engine=engine_name, device=device,
        devices=spec.shard.devices, scan=spec.shard.scan,
        profile=spec.shard.profile, seg_len=spec.window.seg_len, horizon=spec.window.horizon,
        collect=spec.window.collect, arrivals=lv.arrivals,
        admission=lv.admission, rate=lv.rate, messages=lv.messages,
        queue_cap=lv.queue_cap, per_round_cap=lv.per_round_cap,
        slo_p99=lv.slo_p99, seed=spec.seed,
        arrival_params=arrival_params, obs=obs, on_tick=on_tick, ops=ops)
    lr = loop.run()
    res = lr.result

    extras = _vec_extras(spec, res)
    extras["peak_live"] = lr.peak_live
    for key in ("offered", "admitted", "shed_queue", "shed_policy",
                "unserved", "queue_peak", "backpressure_ticks",
                "overflow_catches", "requests_per_sec", "p50", "p99",
                "p999", "mean_latency_rounds"):
        v = getattr(lr, key)
        if isinstance(v, float) and not np.isfinite(v):
            continue
        extras["serve_" + key] = v
    if lr.slo_ok is not None:
        extras["serve_slo_ok"] = int(lr.slo_ok)
    _obs_extras(obs, extras)

    report = RunReport(
        spec=spec, engine=engine_name, device=str(device),
        window=res.window, wall_seconds=lr.wall_seconds, n=scn.n,
        m_app=lr.scenario.m_app, rounds=lr.scenario.rounds,
        stats=res.stats, delivered_frac=lr.delivered_frac,
        mean_latency=res.mean_latency(), extras=extras, result=res,
        scenario=lr.scenario, live=lr, obs=obs)
    # the live result is re-indexed to the admitted scenario, so the
    # batch-mode checkers run on it unchanged (on rank 0 of several)
    if spec.metrics.oracle and _rank() == 0:
        report.oracle = _check_oracle(lr.scenario, engine_name, res)
    if spec.metrics.crossval and _rank() == 0:
        report.crossval_ok = _check_crossval(spec, lr.scenario,
                                             report.window, engine_name,
                                             res, device)
    _write_obs_outputs(spec, report)
    return report


# --------------------------------------------------------------------- #
# The front door
# --------------------------------------------------------------------- #
def run(spec: RunSpec, on_tick=None) -> RunReport:
    """Validate ``spec``, build the scenario, pick the engine, execute
    on the spec's device (the card unless ``device="cpu"``), and
    measure.  A sharded run over several ranks starts them when no
    process group is running (see the module docstring).  ``on_tick``
    (live mode only) is called with a small progress dict after every
    serving tick."""
    spec.validate()
    device = resolve_device(spec.device)
    if spec.mode == "live":
        scn = build_live_scenario(spec)
        engine_name, window = _select_live_engine(spec, scn)
    else:
        scn = build_scenario(spec)
        engine_name, window = select_engine(spec, scn)
    if engine_name == "sharded" and not _in_group():
        world = _device_count(spec)
        if world > 1:
            return _launch_ranks(spec, world, device)
    if spec.mode == "live":
        return _run_live(spec, device, scn, engine_name, window,
                         on_tick=on_tick)
    snapshot_round = _snapshot_round(spec, scn)
    obs = _build_obs(spec, engine_name)

    t0 = time.perf_counter()
    result, stats, frac, latency, extras = ENGINES.get(engine_name)(
        spec, scn, window, snapshot_round, device, obs=obs)
    wall = time.perf_counter() - t0
    _obs_extras(obs, extras)

    report = RunReport(
        spec=spec, engine=engine_name,
        device="object" if engine_name == "exact" else str(device),
        window=(result.window if engine_name in ("windowed", "sharded")
                else None),
        wall_seconds=wall, n=scn.n, m_app=scn.m_app, rounds=scn.rounds,
        stats=stats, delivered_frac=frac, mean_latency=latency,
        extras=extras, result=result, scenario=scn, obs=obs)
    if spec.metrics.oracle and _rank() == 0:
        report.oracle = _check_oracle(scn, engine_name, result)
    if spec.metrics.crossval and _rank() == 0:
        report.crossval_ok = _check_crossval(spec, scn, report.window,
                                             engine_name, result, device)
    _write_obs_outputs(spec, report)
    return report


def _launch_ranks(spec: RunSpec, world: int, device: torch.device
                  ) -> RunReport:
    """Run ``spec`` on ``world`` spawned ranks and return rank 0's
    report; raises if any rank fails.  The ranks meet through a file
    store in a temporary directory, so concurrent launches never fight
    over a port."""
    import torch.multiprocessing as mp
    require_cards(world, device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.pkl")
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(world, device.type,
                                 os.path.join(tmp, "store"), spec, out))
        with open(out, "rb") as fh:
            return pickle.load(fh)


def _rank_main(rank: int, world: int, device_type: str, store: str,
               spec: RunSpec, out: str) -> None:
    """One spawned rank: join the process group, run the spec, and on
    rank 0 pickle the report to ``out``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        # the CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # a rank that stops answering fails the others' collectives after
    # the timeout, so the launch raises instead of hanging
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        rep = run(spec)
        if rank == 0:
            with open(out, "wb") as fh:
                pickle.dump(rep, fh)
    finally:
        dist.destroy_process_group()


def _check_oracle(scn: VecScenario, engine: str, result) -> OracleReport:
    if engine == "exact":
        crashed = {pid for pid, p in result.procs.items() if p.crashed}
        return check_trace(result.trace, crashed=crashed,
                           all_pids=set(range(scn.n)))
    if result.delivered is None:
        raise SpecError(
            "metrics.oracle needs the full delivered matrix; set "
            "window.collect='full' (aggregate-mode windowed runs keep "
            "only per-message counters)")
    crashed = set(np.nonzero(result.state["crashed"])[0].tolist())
    return check_trace(build_trace(result), crashed=crashed,
                       all_pids=set(range(scn.n)))


def _check_crossval(spec: RunSpec, scn: VecScenario,
                    window: Optional[int], engine: str, result,
                    device) -> bool:
    """Replay ``scn`` on the exact engine and compare its delivered
    multiset (and, for ``vc``, its final clocks) with the vec side's:
    the run just executed when it carries the full delivered matrix,
    else a fresh run on ``device`` (the exact engine's own run cannot
    serve as the vec side)."""
    reuse = (result if engine != "exact"
             and getattr(result, "delivered", None) is not None else None)
    out = _crossval.cross_validate(
        scn, seed=spec.seed, device=device, window=window,
        protocol=spec.protocol, vec_result=reuse)
    ok = out["vec_multiset"] == out["exact_multiset"]
    if spec.protocol == "vc":
        ok = ok and out["vec_clocks"] == out["exact_clocks"]
    return bool(ok)
