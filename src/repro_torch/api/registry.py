"""String-keyed registries: the pluggable axes of the port's experiment
API — protocols, engines, topologies, traffic patterns, scenario
families (``DynamicsSpec.kind`` -> :class:`VecScenario` builder), the
live serving policies (arrivals, admission) and the telemetry outputs
(metrics sinks, provenance samplers, audit modes, ops sinks).
``repro_torch.api.run`` resolves every axis of a
:class:`~repro_torch.api.spec.RunSpec` through these tables.  Engine
entries are registered by ``repro_torch.api.run`` at import time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

from ..core.vecsim import scenario as _scn
from ..core.vecsim.live import _ADMISSION, _ARRIVALS
from ..obs.audit import AUDIT_MODES as _AUDIT_MODES
from ..obs.flight import SAMPLERS as _SAMPLERS
from ..obs.ops import OPS_SINKS as _OPS_SINKS
from ..obs.sinks import SINKS as _SINKS
from .spec import RunSpec, SpecError

__all__ = ["Registry", "ProtocolEntry", "EngineEntry", "ScenarioEntry",
           "PROTOCOLS", "ENGINES", "TOPOLOGIES", "TRAFFIC", "SCENARIOS",
           "ARRIVALS", "ADMISSION", "SINKS", "SAMPLERS", "AUDIT",
           "OPS_SINKS", "describe_entry"]


class Registry:
    """A small string-keyed table with informative lookup failures.

    ``items`` may be an existing dict to wrap *live* (no copy): the
    topology and traffic registries share the dispatch tables inside
    ``core.vecsim.scenario``, so registering here makes the key
    immediately buildable by every scenario builder."""

    def __init__(self, name: str, items: Optional[Dict[str, Any]] = None):
        self.name = name
        self._items: Dict[str, Any] = {} if items is None else items

    def register(self, key: str, value: Any = None):
        """Register directly (``register(key, value)``) or as a
        decorator (``@register(key)``)."""
        if value is not None:
            self._add(key, value)
            return value

        def deco(fn):
            self._add(key, fn)
            return fn
        return deco

    def _add(self, key: str, value: Any) -> None:
        if key in self._items:
            raise KeyError(f"{self.name} key {key!r} already registered")
        self._items[key] = value

    def get(self, key: str) -> Any:
        try:
            return self._items[key]
        except KeyError:
            raise KeyError(f"unknown {self.name} key {key!r}; registered: "
                           f"{sorted(self._items)}") from None

    def keys(self) -> Iterable[str]:
        return self._items.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __iter__(self):
        return iter(self._items)


PROTOCOLS = Registry("protocol")
ENGINES = Registry("engine")        # populated by repro_torch.api.run
TOPOLOGIES = Registry("topology", items=_scn._TOPOLOGIES)
TRAFFIC = Registry("traffic", items=_scn._TRAFFIC)
SCENARIOS = Registry("scenario")
# live serving (LiveSpec.arrivals / .admission), wrapped live from
# core.vecsim.live
ARRIVALS = Registry("arrivals", items=_ARRIVALS)
ADMISSION = Registry("admission", items=_ADMISSION)
# telemetry outputs, wrapped live from repro_torch.obs: metrics sinks
# (ObsSpec.sink), provenance samplers (.sampler), causality-audit modes
# (.audit) and live ops-plane sinks (.ops_sink)
SINKS = Registry("sink", items=_SINKS)
SAMPLERS = Registry("sampler", items=_SAMPLERS)
AUDIT = Registry("audit mode", items=_AUDIT_MODES)
OPS_SINKS = Registry("ops sink", items=_OPS_SINKS)


@dataclass(frozen=True)
class ProtocolEntry:
    """One causal-broadcast protocol.  ``mode`` is the
    :class:`VecScenario` mode the pc/r engines execute (None = the
    protocol has its own vec runner); ``windowed`` marks streaming-window
    support."""

    name: str
    description: str
    mode: Optional[str]
    windowed: bool


@dataclass(frozen=True)
class EngineEntry:
    """One execution engine: a runner callable plus the one-line
    description ``python -m repro_torch.api --list`` prints."""

    name: str
    description: str
    run: Callable

    def __call__(self, *args, **kwargs):
        return self.run(*args, **kwargs)


def describe_entry(value: Any) -> str:
    """One-line description of a registry value: its ``description``
    attribute, the value itself when it is a string, or the first
    docstring line of a registered callable."""
    desc = getattr(value, "description", None)
    if isinstance(desc, str) and desc:
        return desc
    if isinstance(value, str):
        return value
    import inspect
    doc = inspect.getdoc(value)
    return doc.splitlines()[0].strip() if doc else ""


PROTOCOLS.register("pc", ProtocolEntry(
    "pc", "PC-broadcast: O(1) control info, link-safety ping gating "
    "(the paper's Algorithm 2)", mode="pc", windowed=True))
PROTOCOLS.register("r", ProtocolEntry(
    "r", "R-broadcast: flooding without link gating (causally unsafe "
    "on dynamic overlays — the Fig. 3 foil)", mode="r", windowed=True))
PROTOCOLS.register("vc", ProtocolEntry(
    "vc", "vector-clock causal broadcast: O(N) piggybacked clocks, "
    "O(W·N) delivery drain (Table 1 baseline, measured)", mode=None,
    windowed=False))

TRAFFIC.register("uniform", "unique (origin, round) broadcasts spread "
                 "uniformly over the schedule window (batch scheduling; "
                 "not a sustained TrafficModel)")


@dataclass(frozen=True)
class ScenarioEntry:
    """Adapter from a validated :class:`RunSpec` to a scenario."""

    name: str
    build: Callable[[RunSpec], Any]
    topologies: Optional[frozenset] = None   # None = any registered
    traffic: Optional[frozenset] = frozenset({"uniform"})  # None = any
    description: str = ""                    # one line for --list

    def check(self, spec: RunSpec) -> None:
        if self.topologies is not None \
                and spec.topology.kind not in self.topologies:
            raise SpecError(
                f"dynamics kind {self.name!r} supports only "
                f"{sorted(self.topologies)} topologies (got "
                f"{spec.topology.kind!r})")
        if self.traffic is not None and spec.traffic.kind not in self.traffic:
            raise SpecError(
                f"dynamics kind {self.name!r} supports only "
                f"{sorted(self.traffic)} traffic (got "
                f"{spec.traffic.kind!r})")


def _mode(spec: RunSpec) -> str:
    """The scenario mode the spec's protocol runs; a protocol with its
    own vec runner (``vc``) reads the pc schedule."""
    entry = PROTOCOLS.get(spec.protocol)
    return entry.mode if entry.mode is not None else "pc"


def _build_none(spec: RunSpec):
    t, tr = spec.topology, spec.traffic
    if tr.kind == "uniform":
        return _scn.static_scenario(
            seed=spec.seed, n=spec.n, k=t.k, m_app=tr.messages,
            max_delay=t.max_delay, mode=_mode(spec),
            pong_delay=spec.pong_delay, topology=t.kind, beta=t.beta)
    return _scn.sustained_scenario(
        seed=spec.seed, n=spec.n, k=t.k, rate=tr.rate,
        messages=tr.messages, topology=t.kind, traffic=tr.kind,
        beta=t.beta, burst_period=tr.period, burst_duty=tr.duty,
        rate_lo=tr.rate_lo, max_delay=t.max_delay, mode=_mode(spec),
        pong_delay=spec.pong_delay)


def _build_link_add(spec: RunSpec):
    t, d = spec.topology, spec.dynamics
    return _scn.link_add_scenario(
        seed=spec.seed, n=spec.n, k=t.k, m_app=spec.traffic.messages,
        n_adds=d.n_adds, max_delay=t.max_delay,
        pong_delay=spec.pong_delay, topology=t.kind, beta=t.beta)


def _build_churn(spec: RunSpec):
    t, d = spec.topology, spec.dynamics
    return _scn.churn_scenario(
        seed=spec.seed, n=spec.n, k=t.k, m_app=spec.traffic.messages,
        n_adds=d.n_adds, n_rms=d.n_rms, max_delay=t.max_delay,
        pong_delay=spec.pong_delay, churn_window=d.churn_window,
        topology=t.kind, beta=t.beta)


def _build_crash(spec: RunSpec):
    t, d = spec.topology, spec.dynamics
    return _scn.crash_scenario(
        seed=spec.seed, n=spec.n, k=t.k, m_app=spec.traffic.messages,
        n_crashes=d.n_crashes, max_delay=t.max_delay,
        pong_delay=spec.pong_delay, topology=t.kind, beta=t.beta)


def _build_partition_heal(spec: RunSpec):
    t, d = spec.topology, spec.dynamics
    return _scn.partition_heal_scenario(
        seed=spec.seed, n=spec.n, k=t.k, m_app=spec.traffic.messages,
        n_bridge=d.n_bridge, max_delay=t.max_delay,
        pong_delay=spec.pong_delay,
        traffic_during_partition=d.traffic_during_partition)


def _build_churn_wave(spec: RunSpec):
    t, d = spec.topology, spec.dynamics
    return _scn.churn_wave_scenario(
        seed=spec.seed, n=spec.n, k=t.k, m_app=spec.traffic.messages,
        waves=d.waves, adds_per_wave=d.n_adds, rms_per_wave=d.n_rms,
        max_delay=t.max_delay, pong_delay=spec.pong_delay,
        topology=t.kind, beta=t.beta)


SCENARIOS.register("none", ScenarioEntry(
    "none", _build_none, traffic=None,   # any registered traffic model
    description="static overlay; batch or sustained traffic only"))
SCENARIOS.register("link_add", ScenarioEntry(
    "link_add", _build_link_add,
    description="batched link additions racing later broadcasts (the "
    "Fig. 3 shortcut that ping gating makes safe)"))
SCENARIOS.register("churn", ScenarioEntry(
    "churn", _build_churn,
    description="interleaved link additions and removals under traffic"))
SCENARIOS.register("crash", ScenarioEntry(
    "crash", _build_crash,
    description="silent mid-broadcast crashes (Fig. 5b)"))
SCENARIOS.register("partition_heal", ScenarioEntry(
    "partition_heal", _build_partition_heal,
    topologies=frozenset({"ring"}),
    description="brownout partition over a thin bridge, then healed "
    "cross links re-gating"))
SCENARIOS.register("churn_wave", ScenarioEntry(
    "churn_wave", _build_churn_wave,
    description="periodic waves of adds+removals with traffic "
    "throughout (diurnal / flash-crowd membership)"))
