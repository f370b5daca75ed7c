"""The vectorized lockstep engines of the port: scenarios, the
monolithic engine (``sim``), the streaming windowed engine (``stream``),
their sweep kernels (``kernels``) and oracle bridges (``metrics``)."""

from .scenario import (INF, TrafficModel, VecScenario, bursty_traffic,
                       churn_scenario, churn_wave_scenario, crash_scenario,
                       diameter_bound, kregular_topology, link_add_scenario,
                       partition_heal_scenario, poisson_traffic,
                       ring_topology, scenario_from_arrays, settle_rounds,
                       smallworld_topology, static_scenario,
                       sustained_scenario)
from .sim import SERIES_FIELDS, VecRunResult, execute_vec
from .stream import (WindowedRunResult, WindowedStepper, WindowOverflowError,
                     execute_windowed)

__all__ = ["INF", "TrafficModel", "VecScenario", "bursty_traffic",
           "churn_scenario", "churn_wave_scenario", "crash_scenario",
           "diameter_bound", "kregular_topology", "link_add_scenario",
           "partition_heal_scenario", "poisson_traffic", "ring_topology",
           "scenario_from_arrays", "settle_rounds", "smallworld_topology",
           "static_scenario", "sustained_scenario", "SERIES_FIELDS",
           "VecRunResult", "execute_vec", "WindowedRunResult",
           "WindowedStepper", "WindowOverflowError", "execute_windowed"]
