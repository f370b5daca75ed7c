"""Traffic accounting schema shared by every engine of the port."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["NetStats"]


@dataclass
class NetStats:
    """Traffic accounting, in the same fields and units as the JAX
    package's ``NetStats`` (bytes follow the wire-size model in
    ``vecsim.sim.stats_from_series``)."""

    sent_messages: int = 0
    sent_control: int = 0  # ping/pong count
    control_bytes: int = 0  # causality-control bytes piggybacked on app msgs
    oob_messages: int = 0
    deliveries: int = 0
    duplicate_receipts: int = 0
