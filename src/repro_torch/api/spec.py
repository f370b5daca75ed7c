"""Declarative experiment specs of the port: the batch-mode ``RunSpec``.

Same sections and field names as the JAX package's ``repro.api.spec``
(topology, traffic, dynamics, window, metrics), with one change:
``backend`` becomes ``device`` — ``None`` (the card, the default) or
``"cpu"``.  :meth:`RunSpec.from_dict` accepts the JAX package's
``RunSpec.to_dict()`` output: its ``backend`` key is dropped, and the
sections this port does not run yet (sharded engine, live serving,
telemetry, the exact engine's cross-validation, the vector-clock
protocol) are accepted only at their defaults — any other value raises
:class:`SpecError` naming the slice of the port that will bring it.

Validation is eager: :meth:`RunSpec.validate` raises :class:`SpecError`
naming the offending field and the valid registry keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Union

__all__ = ["SpecError", "TopologySpec", "TrafficSpec", "DynamicsSpec",
           "WindowSpec", "MetricsSpec", "RunSpec"]


class SpecError(ValueError):
    """An invalid, inconsistent or not-yet-ported :class:`RunSpec`."""


@dataclass(frozen=True)
class TopologySpec:
    """Initial overlay shape (registry: ``repro_torch.api.TOPOLOGIES``)."""

    kind: str = "ring"        # ring | kregular | smallworld
    k: int = 4                # out-link slots per process
    max_delay: int = 3        # per-link delay drawn from [1, max_delay]
    beta: float = 0.2         # smallworld rewiring probability
    free_slots: int = 1       # trailing slots left empty for additions


@dataclass(frozen=True)
class TrafficSpec:
    """Broadcast load shape (registry: ``repro_torch.api.TRAFFIC``)."""

    kind: str = "uniform"     # uniform | poisson | bursty
    messages: int = 8         # total app broadcasts (m_app)
    rate: float = 4.0         # poisson/bursty mean broadcasts per round
    rate_lo: Optional[float] = None   # bursty off-phase rate (default rate/8)
    period: int = 64          # bursty on/off period in rounds
    duty: float = 0.25        # fraction of each period at the high rate


@dataclass(frozen=True)
class DynamicsSpec:
    """Overlay dynamics family (registry: ``repro_torch.api.SCENARIOS``)."""

    kind: str = "none"        # none | link_add | churn | crash |
    #                           partition_heal | churn_wave
    n_adds: Optional[int] = None
    n_rms: Optional[int] = None
    n_crashes: int = 2
    waves: int = 3
    churn_window: Optional[int] = None
    n_bridge: int = 1
    traffic_during_partition: bool = False


@dataclass(frozen=True)
class WindowSpec:
    """Streaming windowed-engine knobs (``core.vecsim.stream``)."""

    window: Optional[int] = None   # live columns; None = auto from budget
    seg_len: int = 32              # rounds per segment between retirements
    horizon: Optional[int] = None  # force-retire columns older than this
    collect: str = "auto"          # full | aggregate | auto


@dataclass(frozen=True)
class MetricsSpec:
    """What to measure beyond the engine's NetStats."""

    snapshot: Optional[Union[int, str]] = None  # round | "last_churn"
    oracle: bool = False       # happens-before oracle on the trace


# Sections and values of the JAX package's RunSpec that this port does
# not run yet: their defaults there, and the slice of the port that
# will bring them.  A reference spec dict may carry them at these
# defaults; anything else is refused.
_LATER_SECTIONS = {
    "shard": ("the sharded-engine slice",
              dict(devices=None, scan="auto", profile=False)),
    "live": ("the live-serving slice",
             dict(arrivals="poisson", admission="defer", rate=8.0,
                  messages=1024, queue_cap=4096, per_round_cap=None,
                  slo_p99=None, rate_lo=None, period=256, duty=0.25)),
    "obs": ("the telemetry slice",
            dict(histograms=None, spans=False, span_capacity=65536,
                 trace_out=None, metrics_out=None, sink="jsonl",
                 provenance=None, sampler="hash", audit="off",
                 ops_out=None, ops_sink="prometheus", ops_every=1,
                 watch=False)),
}
# obs fields whose "off" value is also what the port does
_OBS_OFF = {"histograms": False}
_LATER_VALUES = {
    ("protocol", "vc"): "the vector-clock baseline slice",
    ("engine", "exact"): "the exact-engine slice",
    ("engine", "sharded"): "the sharded-engine slice",
}


def _later(what: str, slice_name: str) -> SpecError:
    return SpecError(f"{what} is not ported to repro_torch yet (it comes "
                     f"with {slice_name}); run it with the JAX package "
                     "repro.api")


@dataclass(frozen=True)
class RunSpec:
    """One batch experiment, declaratively:
    ``repro_torch.api.run(RunSpec(...))``."""

    protocol: str = "pc"       # pc | r   (repro_torch.api.PROTOCOLS)
    engine: str = "auto"       # auto | vec | windowed
    device: Optional[str] = None   # None = the card | "cuda" | "cpu"
    n: int = 64                # processes
    seed: int = 0
    pong_delay: int = 1
    always_gate: bool = False  # paper-faithful unconditional gating
    memory_budget_mb: int = 1024   # N×M budget driving engine auto-select
    topology: TopologySpec = field(default_factory=TopologySpec)
    traffic: TrafficSpec = field(default_factory=TrafficSpec)
    dynamics: DynamicsSpec = field(default_factory=DynamicsSpec)
    window: WindowSpec = field(default_factory=WindowSpec)
    metrics: MetricsSpec = field(default_factory=MetricsSpec)
    # Escape hatch: run a prebuilt VecScenario (topology/traffic/dynamics
    # sections are then ignored).
    scenario: Optional[Any] = None

    # ----------------------------------------------------------------- #
    # validation
    # ----------------------------------------------------------------- #
    def validate(self) -> "RunSpec":
        from . import registry as reg

        def check_key(registry, value, fld):
            if value not in registry:
                raise SpecError(
                    f"{fld}={value!r} is not a registered key; choose "
                    f"from {sorted(registry.keys())}")

        for (fld, value), slice_name in _LATER_VALUES.items():
            if getattr(self, fld) == value:
                raise _later(f"{fld}={value!r}", slice_name)
        for fld, value in (("n", self.n), ("seed", self.seed),
                           ("pong_delay", self.pong_delay),
                           ("memory_budget_mb", self.memory_budget_mb)):
            if not isinstance(value, int) or isinstance(value, bool):
                raise SpecError(f"{fld}={value!r} must be an int")
        check_key(reg.PROTOCOLS, self.protocol, "protocol")
        if self.engine != "auto" and self.engine not in reg.ENGINES:
            raise SpecError(
                f"engine={self.engine!r} must be 'auto' or one of "
                f"{sorted(reg.ENGINES.keys())}")
        if self.device not in (None, "cuda", "cpu"):
            raise SpecError(f"device={self.device!r} must be None (the "
                            "card), 'cuda' or 'cpu'")
        if self.n < 2:
            raise SpecError(f"n={self.n} must be >= 2")
        if self.memory_budget_mb < 1:
            raise SpecError("memory_budget_mb must be >= 1")
        if self.scenario is None:
            check_key(reg.TOPOLOGIES, self.topology.kind, "topology.kind")
            check_key(reg.TRAFFIC, self.traffic.kind, "traffic.kind")
            check_key(reg.SCENARIOS, self.dynamics.kind, "dynamics.kind")
            if self.topology.k < 2:
                raise SpecError(f"topology.k={self.topology.k} must be >= 2")
            if self.topology.max_delay < 1:
                raise SpecError("topology.max_delay must be >= 1")
            if self.traffic.messages < 0:
                raise SpecError("traffic.messages must be >= 0")
            if self.traffic.kind != "uniform" and self.traffic.rate <= 0:
                raise SpecError("traffic.rate must be > 0 for "
                                f"{self.traffic.kind!r} traffic")
            reg.SCENARIOS.get(self.dynamics.kind).check(self)
        if self.window.window is not None and self.window.window < 1:
            raise SpecError("window.window must be >= 1")
        if self.window.seg_len < 1:
            raise SpecError("window.seg_len must be >= 1")
        if self.window.collect not in ("auto", "full", "aggregate"):
            raise SpecError(f"window.collect={self.window.collect!r} must "
                            "be one of ['aggregate', 'auto', 'full']")
        if self.window.window is not None and self.engine == "vec":
            raise SpecError(
                f"window.window={self.window.window} only applies to "
                "engine 'windowed' or 'auto' (got engine='vec'); the "
                "monolithic engine would silently ignore it")
        snap = self.metrics.snapshot
        if snap is not None and not (isinstance(snap, int)
                                     or snap == "last_churn"):
            raise SpecError(f"metrics.snapshot={snap!r} must be a round "
                            "number or 'last_churn'")
        return self

    # ----------------------------------------------------------------- #
    # JSON round-trip
    # ----------------------------------------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        if self.scenario is not None:
            raise SpecError("a spec carrying a prebuilt scenario object "
                            "cannot be serialized to JSON")
        return dataclasses.asdict(replace(self, scenario=None))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        """Build a spec from a (possibly partial) nested dict — unknown
        keys raise, missing keys take the dataclass defaults.  A JAX
        package spec dict is accepted: ``backend`` is dropped in favour
        of ``device``, ``mode="batch"``, ``metrics.crossval=False`` and
        the ``shard``/``live``/``obs`` sections at their defaults pass,
        and any other value of those raises :class:`SpecError`."""
        sections = dict(topology=TopologySpec, traffic=TrafficSpec,
                        dynamics=DynamicsSpec, window=WindowSpec,
                        metrics=MetricsSpec)
        kw: Dict[str, Any] = {}
        top_fields = {f.name for f in dataclasses.fields(cls)}
        for key, value in d.items():
            if key == "backend":
                continue
            if key == "mode":
                if value != "batch":
                    raise _later(f"mode={value!r}", "the live-serving slice")
                continue
            if key in _LATER_SECTIONS:
                _check_later_section(key, value)
                continue
            if key not in top_fields:
                raise SpecError(f"unknown RunSpec field {key!r}; valid "
                                f"fields: {sorted(top_fields)}")
            if key in sections:
                sect_cls = sections[key]
                if not isinstance(value, dict):
                    raise SpecError(
                        f"{key} must be an object of "
                        f"{sect_cls.__name__} fields, got {value!r} — "
                        f"e.g. {{\"{key}\": {{\"kind\": ...}}}}")
                value = dict(value)
                if key == "metrics" and "crossval" in value:
                    if value.pop("crossval"):
                        raise _later("metrics.crossval=True",
                                     "the exact-engine slice")
                sect_fields = {f.name for f in dataclasses.fields(sect_cls)}
                bad = set(value) - sect_fields
                if bad:
                    raise SpecError(
                        f"unknown {key} field(s) {sorted(bad)}; valid "
                        f"fields: {sorted(sect_fields)}")
                kw[key] = sect_cls(**value)
            else:
                kw[key] = value
        return cls(**kw)


def _check_later_section(key: str, value: Any) -> None:
    slice_name, defaults = _LATER_SECTIONS[key]
    if not isinstance(value, dict):
        raise SpecError(f"{key} must be an object, got {value!r}")
    for fld, v in value.items():
        if fld not in defaults:
            raise SpecError(f"unknown {key} field {fld!r}; valid fields: "
                            f"{sorted(defaults)}")
        off = key == "obs" and fld in _OBS_OFF and v == _OBS_OFF[fld]
        if v != defaults[fld] and not off:
            raise _later(f"{key}.{fld}={v!r}", slice_name)
