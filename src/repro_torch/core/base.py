"""Application message identity (the paper's O(1) control information).

Each broadcast message piggybacks a single ``(origin, counter)`` pair;
the oracle and the trace builder key deliveries by it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

__all__ = ["AppMsg", "msg_id"]


@dataclass(frozen=True)
class AppMsg:
    """An application broadcast message, identified by ``(origin,
    counter)``; ``payload`` is application data and ``vc`` is carried
    only by a vector-clock baseline."""

    origin: int
    counter: int
    payload: Any = None
    vc: Optional[Tuple[int, ...]] = None


def msg_id(m: AppMsg) -> Tuple[int, int]:
    return (m.origin, m.counter)
