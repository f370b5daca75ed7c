"""Message types and the protocol base class shared by Algorithms 1-3.

Message identifiers follow the paper (§3.4, *Reliable broadcast*): each
broadcast message piggybacks a single ``(origin, counter)`` pair — O(1)
control information.  ``control_bytes`` makes that accounting explicit so
benchmarks can compare against the vector-clock baseline's O(N) overhead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["AppMsg", "Ping", "Pong", "Protocol", "msg_id", "control_bytes"]

# Wire-size model (bytes) used for overhead accounting.  A process id and a
# counter are both modelled as 8-byte integers.
_INT = 8


@dataclass(frozen=True)
class AppMsg:
    """An application broadcast message.

    ``origin``/``counter`` identify the message (O(1) control information).
    ``payload`` is application data (not counted as overhead).
    ``vc`` is ONLY used by the vector-clock baseline (None for PC-broadcast);
    its size is what Table 1 charges as O(N) message overhead.
    """

    origin: int
    counter: int
    payload: Any = None
    vc: Optional[Tuple[int, ...]] = None  # baseline only


@dataclass(frozen=True)
class Ping:
    """Ping pi: travels over *safe* links (flooded or routed)."""

    frm: int
    to: int
    id: int
    # routing support: remaining path (tuple of pids) when ping_mode="route"
    route: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class Pong:
    """Pong rho: may travel over *any* communication mean (out-of-band)."""

    frm: int  # the pinging process (paper: from = p)
    to: int   # the pinged process
    id: int


def msg_id(m: AppMsg) -> Tuple[int, int]:
    return (m.origin, m.counter)


def control_bytes(m: Any) -> int:
    """Causality-control bytes carried by a message (overhead accounting)."""
    if isinstance(m, AppMsg):
        if m.vc is not None:
            return _INT * 2 + _INT * len(m.vc)  # id + vector clock
        return _INT * 2  # id only — the paper's O(1)
    if isinstance(m, (Ping, Pong)):
        return _INT * 3
    return 0


class Protocol:
    """Base class: a process running one broadcast protocol instance."""

    def __init__(self, pid: int, deliver_cb: Optional[Callable[[int, AppMsg], None]] = None):
        self.pid = pid
        self.net = None  # set by Network.add_process
        self.crashed = False
        self.counter = 0  # per-process broadcast message counter
        self.delivered_log: List[AppMsg] = []
        self._deliver_cb = deliver_cb

    # -- hooks the Network invokes ------------------------------------- #
    def on_open(self, q: int) -> None:  # link self -> q added
        raise NotImplementedError

    def on_close(self, q: int) -> None:  # link self -> q removed
        raise NotImplementedError

    def on_receive(self, src: int, msg: Any) -> None:
        raise NotImplementedError

    def on_oob(self, src: int, msg: Any) -> None:
        pass

    def on_timeout(self, payload: Any) -> None:
        pass

    # -- helpers -------------------------------------------------------- #
    def send(self, dst: int, msg: Any) -> None:
        self.net.stats.control_bytes += control_bytes(msg)
        if isinstance(msg, (Ping, Pong)):
            self.net.stats.sent_control += 1
        self.net.send(self.pid, dst, msg)

    def deliver(self, m: AppMsg) -> None:
        self.delivered_log.append(m)
        self.net.record_delivery(self.pid, m)
        if self._deliver_cb is not None:
            self._deliver_cb(self.pid, m)

    def next_message(self, payload: Any = None) -> AppMsg:
        self.counter += 1
        return AppMsg(self.pid, self.counter, payload)
