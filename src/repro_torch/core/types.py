"""Shared simulation types: traffic stats and link-delay models.

``NetStats`` is the accounting schema every engine of the port fills —
the exact event simulator (``core.events.Network``) and the vectorized
engines (``core.vecsim``) alike.  ``DelayFn`` is the exact simulator's
transmission-delay model.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable

__all__ = ["NetStats", "DelayFn", "constant_delay", "uniform_delay"]

# A transmission-delay model: (current time, rng) -> delay.
DelayFn = Callable[[float, random.Random], float]


def constant_delay(d: float) -> DelayFn:
    return lambda t, rng: d


def uniform_delay(lo: float, hi: float) -> DelayFn:
    return lambda t, rng: rng.uniform(lo, hi)


@dataclass
class NetStats:
    """Traffic accounting, in the same fields and units as the JAX
    package's ``NetStats`` (bytes follow the wire-size model of
    ``core.base.control_bytes``)."""

    sent_messages: int = 0
    sent_control: int = 0  # ping/pong count
    control_bytes: int = 0  # causality-control bytes piggybacked on app msgs
    oob_messages: int = 0
    deliveries: int = 0
    duplicate_receipts: int = 0
