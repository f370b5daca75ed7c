"""The port's one front door: ``run(RunSpec(...)) -> RunReport``.

    from repro_torch.api import RunSpec, TrafficSpec, WindowSpec, run
    rep = run(RunSpec(protocol="pc", n=10_000, engine="windowed",
                      topology=TopologySpec(kind="kregular", k=8,
                                            max_delay=1, free_slots=0),
                      traffic=TrafficSpec(kind="poisson", rate=1000.0,
                                          messages=1_000_000),
                      window=WindowSpec(window=16384, seg_len=8,
                                        collect="aggregate")))

Runs on the card unless ``device="cpu"``; ``python -m repro_torch.api``
is the command-line form.
"""

from .registry import (ENGINES, PROTOCOLS, SCENARIOS, TOPOLOGIES, TRAFFIC,
                       EngineEntry, ProtocolEntry, Registry, ScenarioEntry,
                       describe_entry)
from .run import RunReport, build_scenario, run, select_engine
from .spec import (DynamicsSpec, MetricsSpec, RunSpec, SpecError,
                   TopologySpec, TrafficSpec, WindowSpec)

__all__ = ["run", "RunReport", "RunSpec", "SpecError", "TopologySpec",
           "TrafficSpec", "DynamicsSpec", "WindowSpec", "MetricsSpec",
           "build_scenario", "select_engine", "Registry", "ProtocolEntry",
           "EngineEntry", "ScenarioEntry", "PROTOCOLS", "ENGINES",
           "TOPOLOGIES", "TRAFFIC", "SCENARIOS", "describe_entry"]
