"""The vectorized lockstep engines of the port: scenarios, the
monolithic engine (``sim``), the streaming windowed engine (``stream``),
their sweep kernels (``kernels``), the vector-clock baseline (``vc``),
the Fig. 7 metrics and oracle bridges (``metrics``) and the
cross-validation against the exact event engine (``crossval``)."""

from .crossval import (cross_validate, delivered_multiset_exact,
                       final_clocks_exact, run_exact)
from .metrics import (build_trace, delivered_multiset, full_out_mask,
                      mean_shortest_path_vec, safe_out_mask,
                      unsafe_link_stats_vec, vc_overhead_model)
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
from .vc import VCVecRunResult, run_vec_vc

__all__ = ["INF", "TrafficModel", "VecScenario", "bursty_traffic",
           "churn_scenario", "churn_wave_scenario", "crash_scenario",
           "diameter_bound", "kregular_topology", "link_add_scenario",
           "partition_heal_scenario", "poisson_traffic", "ring_topology",
           "scenario_from_arrays", "settle_rounds", "smallworld_topology",
           "static_scenario", "sustained_scenario", "SERIES_FIELDS",
           "VecRunResult", "execute_vec", "WindowedRunResult",
           "WindowedStepper", "WindowOverflowError", "execute_windowed",
           "VCVecRunResult", "run_vec_vc",
           "safe_out_mask", "full_out_mask", "mean_shortest_path_vec",
           "unsafe_link_stats_vec", "build_trace", "delivered_multiset",
           "vc_overhead_model",
           "run_exact", "delivered_multiset_exact", "final_clocks_exact",
           "cross_validate"]
