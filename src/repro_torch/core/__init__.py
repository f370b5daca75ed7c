"""Protocol-level types and the exact event engine of the port.

Discrete-event implementations of the paper's three algorithms
(R-broadcast, PC-broadcast, bounded PC-broadcast), the vector-clock
baseline, the Spray-like dynamic overlay and the happens-before oracle
— the port's own copies of the JAX package's ``repro.core`` modules,
held byte-identical to them by ``tests/test_torch_exact.py``.  The
vectorized engines live in ``core.vecsim``.
"""

from .base import AppMsg, Ping, Pong, Protocol, control_bytes, msg_id
from .bounded import BoundedPCBroadcast
from .events import Link, Network
from .oracle import OracleReport, check_trace
from .overlay import SprayOverlay, ring_plus_random, view_size
from .pcbroadcast import PCBroadcast
from .rbroadcast import RBroadcast
from .types import DelayFn, NetStats, constant_delay, uniform_delay
from .vector_clock import VCBroadcast

__all__ = [
    "AppMsg", "Ping", "Pong", "Protocol", "control_bytes", "msg_id",
    "BoundedPCBroadcast", "Link", "NetStats", "Network",
    "DelayFn", "constant_delay", "uniform_delay",
    "OracleReport", "check_trace",
    "SprayOverlay", "ring_plus_random", "view_size",
    "PCBroadcast", "RBroadcast", "VCBroadcast",
]
