"""``repro_torch.api.run`` — the port's front door for batch experiments.

``run(spec)`` resolves every axis of a validated :class:`RunSpec`
through the registries, builds (or accepts) the scenario, picks the
engine, executes on the spec's device, and returns a :class:`RunReport`.

Engine auto-selection, on one device (the JAX package's DESIGN.md §3.3
rule without the sharded engine): with ``engine="auto"``,

  1. an explicit ``window.window`` selects the streaming windowed engine;
  2. otherwise the monolithic vec engine runs iff its two dense
     ``(N, M_total)`` int32 planes fit the spec's memory budget
     (``8·N·M_total <= memory_budget_mb``);
  3. otherwise the windowed engine runs with
     ``window = clamp(budget // (8·N), 64, M_total)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..backend import resolve_device
from ..core.oracle import OracleReport, check_trace
from ..core.types import NetStats
from ..core.vecsim.metrics import build_trace
from ..core.vecsim.scenario import VecScenario
from ..core.vecsim.sim import execute_vec
from ..core.vecsim.stream import execute_windowed
from .registry import ENGINES, PROTOCOLS, SCENARIOS, EngineEntry
from .spec import RunSpec, SpecError

__all__ = ["RunReport", "run", "build_scenario", "select_engine"]


@dataclass
class RunReport:
    """Uniform result of :func:`run`, whatever engine executed."""

    spec: RunSpec
    engine: str                # engine that actually ran
    device: str                # torch device the engine ran on
    window: Optional[int]      # live columns (windowed engine only)
    wall_seconds: float
    n: int
    m_app: int
    rounds: int
    stats: NetStats
    delivered_frac: float
    mean_latency: float        # rounds
    extras: Dict[str, float] = field(default_factory=dict)
    oracle: Optional[OracleReport] = None
    result: Any = None         # the raw engine result object
    scenario: Any = None       # the VecScenario that ran

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
    want_mode = PROTOCOLS.get(spec.protocol).mode
    if scn.mode != want_mode or scn.always_gate != spec.always_gate:
        scn = replace(scn, mode=want_mode,
                      always_gate=spec.always_gate).validate()
    return scn


def _auto_window(spec: RunSpec, scn: VecScenario) -> int:
    """The budget-derived window: ``clamp(budget // (8·N), 64,
    M_total)`` live columns."""
    budget = spec.memory_budget_mb * 2 ** 20
    return int(min(max(64, budget // (8 * scn.n)), scn.m_total))


def select_engine(spec: RunSpec, scn: VecScenario
                  ) -> Tuple[str, Optional[int]]:
    """Apply the one-device auto-selection rule; explicit engines pass
    through unchanged (with the spec's window, if any)."""
    if spec.engine != "auto":
        return spec.engine, spec.window.window
    if spec.window.window is not None:
        return "windowed", spec.window.window
    if 8 * scn.n * max(scn.m_total, 1) <= spec.memory_budget_mb * 2 ** 20:
        return "vec", None
    return "windowed", _auto_window(spec, scn)


def _snapshot_round(spec: RunSpec, scn: VecScenario) -> Optional[int]:
    snap = spec.metrics.snapshot
    if snap == "last_churn":
        return int(scn.add_round[-1]) if scn.n_adds else None
    return snap


# --------------------------------------------------------------------- #
# Engine adapters (registered under repro_torch.api.ENGINES)
# --------------------------------------------------------------------- #
def _vec_extras(res) -> Dict[str, float]:
    return {
        "overhead_bytes_per_msg": res.stats.control_bytes
        / max(res.stats.sent_messages, 1),
        "gated_link_rounds": int(res.series[:, 5].sum()),
        "pongs": int(res.series[:, 4].sum()),
    }


def _run_vec(spec: RunSpec, scn: VecScenario, window: Optional[int],
             snapshot_round: Optional[int], device):
    res = execute_vec(scn, device=device, snapshot_round=snapshot_round)
    return (res, res.stats, res.delivered_frac(), res.mean_latency(),
            _vec_extras(res))


def _run_windowed(spec: RunSpec, scn: VecScenario, window: Optional[int],
                  snapshot_round: Optional[int], device):
    if window is None:
        # explicit engine="windowed" without a window: the budget rule
        window = _auto_window(spec, scn)
    res = execute_windowed(
        scn, window, device=device, horizon=spec.window.horizon,
        seg_len=spec.window.seg_len, snapshot_round=snapshot_round,
        collect=spec.window.collect)
    extras = _vec_extras(res)
    extras["peak_live"] = res.peak_live
    extras["expired_columns"] = int(res.expired.sum())
    return (res, res.stats, res.delivered_frac(), res.mean_latency(),
            extras)


ENGINES.register("vec", EngineEntry(
    "vec", "monolithic vectorized lockstep engine: dense (N, M_total) "
    "planes on the device", _run_vec))
ENGINES.register("windowed", EngineEntry(
    "windowed", "streaming windowed engine: O(N*window) live-column "
    "planes kept on the device for sustained traffic", _run_windowed))


# --------------------------------------------------------------------- #
# The front door
# --------------------------------------------------------------------- #
def run(spec: RunSpec) -> RunReport:
    """Validate ``spec``, build the scenario, pick the engine, execute
    on the spec's device (the card unless ``device="cpu"``), and
    measure."""
    spec.validate()
    device = resolve_device(spec.device)
    scn = build_scenario(spec)
    engine_name, window = select_engine(spec, scn)
    snapshot_round = _snapshot_round(spec, scn)

    t0 = time.perf_counter()
    result, stats, frac, latency, extras = ENGINES.get(engine_name)(
        spec, scn, window, snapshot_round, device)
    wall = time.perf_counter() - t0

    report = RunReport(
        spec=spec, engine=engine_name, device=str(device),
        window=(result.window if engine_name == "windowed" else None),
        wall_seconds=wall, n=scn.n, m_app=scn.m_app, rounds=scn.rounds,
        stats=stats, delivered_frac=frac, mean_latency=latency,
        extras=extras, result=result, scenario=scn)
    if spec.metrics.oracle:
        report.oracle = _check_oracle(scn, result)
    return report


def _check_oracle(scn: VecScenario, result) -> OracleReport:
    if result.delivered is None:
        raise SpecError(
            "metrics.oracle needs the full delivered matrix; set "
            "window.collect='full' (aggregate-mode windowed runs keep "
            "only per-message counters)")
    crashed = set(np.nonzero(result.state["crashed"])[0].tolist())
    return check_trace(build_trace(result), crashed=crashed,
                       all_pids=set(range(scn.n)))
