"""repro_torch.obs — the port's telemetry: its own copy of the JAX
package's ``repro.obs`` (DESIGN.md §2.10-§2.11), minus the benchmark
report writer (``report.py``, which comes with the port's benchmarks).

* **Latency histograms** (``hist.py``): the 32-bucket log contract and
  the nearest-rank percentile read-out; on the card the per-column
  histogram of the retiring columns is the ``latency_hist`` kernel.
* **Trace spans** (``spans.py``): the ring recorder (``SpanRecorder`` /
  ``NULL_RECORDER``) and the per-run accumulator ``EngineObs``.
* **Export sinks** (``sinks.py``): schema-versioned JSONL metrics and
  Perfetto-loadable Chrome trace JSON, behind ``SINKS``.
* **Flight recorder** (``flight.py``), **causality auditor**
  (``audit.py``) and **live ops plane** (``ops.py``).
* **Protocol graph metrics** (``graphs.py``): safe-graph path lengths,
  unsafe links and overhead over the exact engine's ``Network``.

The file formats are the reference's, schema names included, so a file
either package writes loads in the other.
"""

from .audit import (AUDIT_MODES, AuditMode, CausalAuditor,
                    CausalityViolationError, Violation)
from .flight import (SAMPLERS, FlightRecord, FlightRecorder,
                     FlightSampler, provenance_trace_events)
from .graphs import (full_graph, mean_shortest_path, overhead_per_message,
                     safe_graph, unsafe_link_stats)
from .hist import (NB, bucket_index_np, bucket_index_torch,
                   bucket_lower_bounds, hist_np, merge_hists,
                   percentiles_from_hist)
from .ops import (OPS_SCHEMA, OPS_SCHEMA_VERSION, OPS_SINKS, OpsPlane,
                  OpsSink, SloBurn, WatchDashboard, load_ops_jsonl)
from .sinks import (METRICS_SCHEMA, METRICS_VERSION, SINKS, MetricsSink,
                    load_metrics_jsonl, write_chrome_trace,
                    write_metrics_jsonl)
from .spans import NULL_RECORDER, EngineObs, SpanRecorder

__all__ = [
    "NB", "bucket_index_np", "bucket_index_torch", "bucket_lower_bounds",
    "hist_np", "merge_hists", "percentiles_from_hist",
    "SpanRecorder", "NULL_RECORDER", "EngineObs",
    "MetricsSink", "SINKS", "METRICS_SCHEMA", "METRICS_VERSION",
    "write_metrics_jsonl", "load_metrics_jsonl", "write_chrome_trace",
    "SAMPLERS", "FlightSampler", "FlightRecord", "FlightRecorder",
    "provenance_trace_events",
    "AUDIT_MODES", "AuditMode", "CausalAuditor",
    "CausalityViolationError", "Violation",
    "OPS_SCHEMA", "OPS_SCHEMA_VERSION", "OPS_SINKS", "OpsSink",
    "OpsPlane", "SloBurn", "WatchDashboard", "load_ops_jsonl",
    "safe_graph", "full_graph", "mean_shortest_path",
    "unsafe_link_stats", "overhead_per_message",
]
