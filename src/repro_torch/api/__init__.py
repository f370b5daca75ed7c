"""The port's one front door: ``run(RunSpec(...)) -> RunReport``.

    from repro_torch.api import RunSpec, TrafficSpec, WindowSpec, run
    rep = run(RunSpec(protocol="pc", n=10_000, engine="windowed",
                      topology=TopologySpec(kind="kregular", k=8,
                                            max_delay=1, free_slots=0),
                      traffic=TrafficSpec(kind="poisson", rate=1000.0,
                                          messages=1_000_000),
                      window=WindowSpec(window=16384, seg_len=8,
                                        collect="aggregate")))

    rep = run(RunSpec(mode="live", n=65_536, engine="windowed",
                      topology=TopologySpec(kind="kregular", k=4,
                                            max_delay=1),
                      live=LiveSpec(arrivals="bursty", rate=64.0,
                                    messages=200_000),
                      window=WindowSpec(window=1024, seg_len=16,
                                        collect="aggregate"),
                      obs=ObsSpec(provenance=1024, audit="fail")))

Runs on the card unless ``device="cpu"``; ``python -m repro_torch.api``
(``--serve`` for live mode) is the command-line form.
"""

from .registry import (ADMISSION, ARRIVALS, AUDIT, ENGINES, OPS_SINKS,
                       PROTOCOLS, SAMPLERS, SCENARIOS, SINKS, TOPOLOGIES,
                       TRAFFIC, EngineEntry, ProtocolEntry, Registry,
                       ScenarioEntry, describe_entry)
from .run import (RunReport, build_live_scenario, build_scenario, run,
                  select_engine)
from .spec import (DynamicsSpec, LiveSpec, MetricsSpec, ObsSpec, RunSpec,
                   SpecError, TopologySpec, TrafficSpec, WindowSpec)

__all__ = ["run", "RunReport", "RunSpec", "SpecError", "TopologySpec",
           "TrafficSpec", "DynamicsSpec", "WindowSpec", "LiveSpec",
           "MetricsSpec", "ObsSpec", "build_scenario", "build_live_scenario",
           "select_engine", "Registry", "ProtocolEntry", "EngineEntry",
           "ScenarioEntry", "PROTOCOLS", "ENGINES", "TOPOLOGIES", "TRAFFIC",
           "SCENARIOS", "ARRIVALS", "ADMISSION", "SINKS", "SAMPLERS",
           "AUDIT", "OPS_SINKS", "describe_entry"]
