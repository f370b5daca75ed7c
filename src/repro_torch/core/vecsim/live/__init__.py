"""Live-traffic serving front door of the port: its own copy of the JAX
package's ``repro.core.vecsim.live`` (DESIGN.md §2.9), on the windowed
engine.

Open-loop causal-broadcast ingest: an :class:`ArrivalProcess` drives
submissions into a bounded queue, an :class:`AdmissionPolicy` plans
them into each segment's rounds, a :class:`LiveColumnWindow` grows the
engine's broadcast schedule between segments, and :class:`LiveLoop`
ties it together with backpressure (the window-occupancy signal and the
state-clean ``WindowOverflowError`` catch-and-defer path) plus
rounds-to-delivery latency SLOs.
"""

from .admission import _ADMISSION, AdmissionPolicy
from .arrivals import _ARRIVALS, ArrivalProcess, build_arrivals
from .loop import (LiveLoop, LiveReport, default_per_round_cap,
                   serving_bound)
from .window import LiveColumnWindow

__all__ = [
    "AdmissionPolicy", "_ADMISSION",
    "ArrivalProcess", "_ARRIVALS", "build_arrivals",
    "LiveColumnWindow",
    "LiveLoop", "LiveReport", "default_per_round_cap", "serving_bound",
]
