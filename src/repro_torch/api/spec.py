"""Declarative experiment specs of the port: ``RunSpec``, batch or live.

Same sections and field names as the JAX package's ``repro.api.spec``
(topology, traffic, dynamics, window, shard, live, metrics, obs), with
one change: ``backend`` becomes ``device`` — ``None`` (the card, the
default) or ``"cpu"``.  The same protocols (``pc``, ``r`` and the
vector-clock baseline ``vc``), engines (``exact``, ``vec``,
``windowed``, ``sharded``) and metrics (the oracle, the exact-engine
cross-validation) as the reference.  :meth:`RunSpec.from_dict` accepts
the JAX package's ``RunSpec.to_dict()`` output; its ``backend`` key is
dropped.

Validation is eager: :meth:`RunSpec.validate` raises :class:`SpecError`
naming the offending field and the valid registry keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Union

__all__ = ["SpecError", "TopologySpec", "TrafficSpec", "DynamicsSpec",
           "WindowSpec", "ShardSpec", "LiveSpec", "ObsSpec", "MetricsSpec",
           "RunSpec"]


class SpecError(ValueError):
    """An invalid or inconsistent :class:`RunSpec`."""


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
class ShardSpec:
    """Rank knobs of the sharded engine (``core.vecsim.shard``).

    ``devices`` is the number of ranks the process axis is split over
    (``None``: the running process group's, 1 without one).  When it is
    above 1 and no process group is running, ``run`` starts that many
    ranks itself: NCCL with one card a rank on the card, gloo on the
    CPU.  ``scan`` picks the segment loop: ``"on"`` (what ``"auto"``
    means) defers each round's frontier exchange, fuses the retirement
    reduction into the segment, stages schedules through persistent
    device buffers and runs topology-quiescent segments through the
    bit-packed fast body; ``"off"`` steps every round through the
    generic body.  The results are byte-identical.  ``profile=True``
    records per-segment host times (``result.seg_profile``) and their
    totals in the report extras."""

    devices: Optional[int] = None   # ranks; None = the process group's
    scan: str = "auto"              # segment loop: auto | on | off
    profile: bool = False           # per-segment timing breakdown


@dataclass(frozen=True)
class LiveSpec:
    """Live serving-mode knobs (``mode="live"``; DESIGN.md §2.9).

    In live mode the run is an *open-loop service*: an arrival process
    (registry: ``repro_torch.api.ARRIVALS``) submits broadcasts into a
    bounded ingest queue as simulated time passes, and an admission
    policy (registry: ``repro_torch.api.ADMISSION``) plans each
    segment's micro-batch against the engine's window-occupancy
    backpressure signal.  The ``traffic`` section is ignored — live
    traffic is not pre-scripted — while topology/dynamics still shape
    the overlay under serving.

    ``per_round_cap`` bounds admissions per simulated round (default
    ``min(n, max(4, ceil(3·rate)))``).  ``slo_p99`` is a
    rounds-to-delivery target: the report's ``slo_ok`` says whether the
    measured p99 (queueing delay included) met it."""

    arrivals: str = "poisson"      # repro_torch.api.ARRIVALS key
    admission: str = "defer"       # repro_torch.api.ADMISSION key
    rate: float = 8.0              # mean offered submissions per round
    messages: int = 1024           # total submissions offered
    queue_cap: int = 4096          # bounded ingest queue (tail-drop)
    per_round_cap: Optional[int] = None   # admissions per round; None=auto
    slo_p99: Optional[float] = None       # p99 rounds-to-delivery target
    rate_lo: Optional[float] = None       # bursty baseline (default rate/8)
    period: int = 256              # bursty/diurnal period in rounds
    duty: float = 0.25             # bursty high-rate fraction of period


@dataclass(frozen=True)
class ObsSpec:
    """Telemetry knobs (``repro_torch.obs``; DESIGN.md §2.10-§2.11).

    ``histograms=None`` (the default) turns the delivery-latency
    histogram on wherever an engine supports it (the windowed engine
    and every live run) and off on the monolithic engine; an explicit
    bool forces it.  Results are byte-identical either way.

    ``spans`` records structured trace spans (live-loop ticks, segment
    dispatch/retire phases) into a preallocated ring; ``trace_out``
    writes them as Perfetto-loadable Chrome trace JSON and implies
    ``spans=True``.  ``metrics_out`` writes the run's
    histogram/gauge/counter doc through the named ``sink`` (registry:
    ``repro_torch.api.SINKS``).

    **Flight recorder**: ``provenance=R`` samples 1-in-R application
    broadcasts (via ``sampler``, registry ``repro_torch.api.SAMPLERS``;
    seeded by the run seed) and records their full lifecycle — exported
    as ``provenance`` JSONL records and per-message Perfetto tracks.
    ``audit`` (registry ``repro_torch.api.AUDIT``) runs the online
    causality auditor over the sampled records during execution; it
    requires ``provenance``.  Windowed and live runs only.

    **Live ops plane**: ``ops_out`` streams per-tick gauges through
    ``ops_sink`` (registry: ``repro_torch.api.OPS_SINKS``) every
    ``ops_every`` ticks; ``watch`` renders a terminal dashboard (plain
    lines when stderr is not a TTY).  Live mode only."""

    histograms: Optional[bool] = None   # None = auto per engine
    spans: bool = False                 # record trace spans
    span_capacity: int = 65536          # span ring size (events)
    trace_out: Optional[str] = None     # Chrome trace JSON (implies spans)
    metrics_out: Optional[str] = None   # metrics doc path (via `sink`)
    sink: str = "jsonl"                 # repro_torch.api.SINKS key
    provenance: Optional[int] = None    # sample 1-in-N broadcasts
    sampler: str = "hash"               # repro_torch.api.SAMPLERS key
    audit: str = "off"                  # repro_torch.api.AUDIT key
    ops_out: Optional[str] = None       # live ops stream path
    ops_sink: str = "prometheus"        # repro_torch.api.OPS_SINKS key
    ops_every: int = 1                  # publish every N ticks
    watch: bool = False                 # --watch terminal dashboard


@dataclass(frozen=True)
class MetricsSpec:
    """What to measure beyond the engine's NetStats."""

    snapshot: Optional[Union[int, str]] = None  # round | "last_churn"
    oracle: bool = False       # happens-before oracle on the trace
    crossval: bool = False     # replay on the exact engine and compare


@dataclass(frozen=True)
class RunSpec:
    """One experiment, declaratively:
    ``repro_torch.api.run(RunSpec(...))``."""

    protocol: str = "pc"       # pc | r | vc   (repro_torch.api.PROTOCOLS)
    mode: str = "batch"        # batch (pre-scripted) | live (open-loop)
    engine: str = "auto"       # auto | exact | vec | windowed | sharded
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
    shard: ShardSpec = field(default_factory=ShardSpec)
    live: LiveSpec = field(default_factory=LiveSpec)
    metrics: MetricsSpec = field(default_factory=MetricsSpec)
    obs: ObsSpec = field(default_factory=ObsSpec)
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
        proto = reg.PROTOCOLS.get(self.protocol)
        wants_window = (self.engine in ("windowed", "sharded")
                        or self.window.window is not None)
        if wants_window and not proto.windowed:
            raise SpecError(
                f"protocol {self.protocol!r} has no windowed engine "
                "(its state is O(N·m_app) already); use engine='vec' "
                "and drop window.window")
        if self.window.window is not None \
                and self.engine in ("vec", "exact"):
            raise SpecError(
                f"window.window={self.window.window} only applies to "
                f"engine 'windowed', 'sharded' or 'auto' (got engine="
                f"{self.engine!r}); the monolithic/exact engines would "
                "silently ignore it")
        sh = self.shard
        one_device = self.engine in ("vec", "exact", "windowed")
        if sh.devices is not None:
            if not isinstance(sh.devices, int) \
                    or isinstance(sh.devices, bool) or sh.devices < 1:
                raise SpecError(f"shard.devices={sh.devices!r} must be an "
                                "int >= 1 (or None for the process "
                                "group's)")
            if one_device:
                raise SpecError(
                    f"shard.devices={sh.devices} only applies to engine "
                    f"'sharded' or 'auto' (got engine={self.engine!r}); "
                    "one-device engines would silently ignore it")
        if sh.scan not in ("auto", "on", "off"):
            raise SpecError(f"shard.scan={sh.scan!r} must be one of "
                            "['auto', 'off', 'on']")
        if sh.scan != "auto" and one_device:
            raise SpecError(
                f"shard.scan={sh.scan!r} only applies to engine 'sharded' "
                f"or 'auto' (got engine={self.engine!r}); one-device "
                "engines would silently ignore it")
        if sh.profile and one_device:
            raise SpecError(
                f"shard.profile=True only applies to engine 'sharded' or "
                f"'auto' (got engine={self.engine!r}); one-device engines "
                "have no per-segment staging to profile")
        ob = self.obs
        if ob.histograms is not None and not isinstance(ob.histograms,
                                                        bool):
            raise SpecError(f"obs.histograms={ob.histograms!r} must be a "
                            "bool or None (auto)")
        if not isinstance(ob.span_capacity, int) \
                or isinstance(ob.span_capacity, bool) \
                or ob.span_capacity < 1:
            raise SpecError(f"obs.span_capacity={ob.span_capacity!r} must "
                            "be an int >= 1")
        check_key(reg.SINKS, ob.sink, "obs.sink")
        if ob.provenance is not None and (
                not isinstance(ob.provenance, int)
                or isinstance(ob.provenance, bool)
                or ob.provenance < 1):
            raise SpecError(f"obs.provenance={ob.provenance!r} must be "
                            "an int >= 1 (sample 1-in-N) or None")
        check_key(reg.SAMPLERS, ob.sampler, "obs.sampler")
        check_key(reg.AUDIT, ob.audit, "obs.audit")
        check_key(reg.OPS_SINKS, ob.ops_sink, "obs.ops_sink")
        if not isinstance(ob.ops_every, int) \
                or isinstance(ob.ops_every, bool) or ob.ops_every < 1:
            raise SpecError(f"obs.ops_every={ob.ops_every!r} must be an "
                            "int >= 1")
        if ob.audit != "off" and ob.provenance is None:
            raise SpecError("obs.audit consumes sampled provenance "
                            "records; set obs.provenance (e.g. 1 to "
                            "sample everything)")
        if ob.provenance is not None and self.mode != "live" \
                and self.engine in ("vec", "exact"):
            raise SpecError(
                f"obs.provenance needs a streaming engine (the hooks "
                f"ride column retirement); engine={self.engine!r} has "
                "no window to sample — use 'windowed', 'sharded' or "
                "'auto'")
        if self.mode != "live" and (ob.ops_out is not None or ob.watch):
            raise SpecError("obs.ops_out/obs.watch are the live ops "
                            "plane; they need mode='live'")
        snap = self.metrics.snapshot
        if snap is not None and not (isinstance(snap, int)
                                     or snap == "last_churn"):
            raise SpecError(f"metrics.snapshot={snap!r} must be a round "
                            "number or 'last_churn'")
        if self.mode not in ("batch", "live"):
            raise SpecError(f"mode={self.mode!r} must be 'batch' or 'live'")
        if self.mode == "live":
            lv = self.live
            check_key(reg.ARRIVALS, lv.arrivals, "live.arrivals")
            check_key(reg.ADMISSION, lv.admission, "live.admission")
            if lv.messages < 1:
                raise SpecError("live.messages must be >= 1")
            if lv.rate <= 0:
                raise SpecError("live.rate must be > 0")
            if lv.queue_cap < 1:
                raise SpecError("live.queue_cap must be >= 1")
            if lv.per_round_cap is not None \
                    and not (1 <= lv.per_round_cap <= self.n):
                raise SpecError(
                    f"live.per_round_cap={lv.per_round_cap} must be in "
                    f"[1, n={self.n}] (one broadcast per (origin, round))")
            if self.engine not in ("auto", "windowed", "sharded"):
                raise SpecError(
                    f"mode='live' serves through a streaming engine; "
                    f"engine must be 'auto', 'windowed' or 'sharded' "
                    f"(got {self.engine!r})")
            if self.protocol == "vc":
                raise SpecError("mode='live' needs a windowed protocol; "
                                "'vc' has no streaming engine")
            if snap is not None:
                raise SpecError("metrics.snapshot is not supported in "
                                "mode='live' (segment boundaries are "
                                "load-dependent)")
            if self.scenario is not None:
                raise SpecError(
                    "mode='live' builds its own broadcast-free base "
                    "scenario from the topology/dynamics sections; a "
                    "prebuilt scenario belongs to batch mode (drive "
                    "LiveLoop directly for custom bases)")
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
        of ``device``."""
        sections = dict(topology=TopologySpec, traffic=TrafficSpec,
                        dynamics=DynamicsSpec, window=WindowSpec,
                        shard=ShardSpec, live=LiveSpec,
                        metrics=MetricsSpec, obs=ObsSpec)
        kw: Dict[str, Any] = {}
        top_fields = {f.name for f in dataclasses.fields(cls)}
        for key, value in d.items():
            if key == "backend":
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

