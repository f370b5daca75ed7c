"""Deterministic discrete-event simulator with FIFO links.

This module is the substrate for the *exact* reproduction of the paper's
algorithms (Algorithms 1-3).  It models:

  * directed FIFO links with (possibly time-varying) transmission delays,
  * an out-of-band channel for pong replies (the paper: "Replies rho travel
    using any communication mean"), optionally lossy,
  * link addition/removal and process crash/departure,
  * per-process timeouts (used by Algorithm 3),
  * a global event trace consumed by the happens-before oracle.

Determinism: the event queue is a heap keyed by (time, seq) where ``seq`` is
a monotone tie-breaker, and all randomness flows from one seeded generator.
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

from .types import DelayFn, NetStats, constant_delay, uniform_delay

__all__ = [
    "Network",
    "Link",
    "NetStats",
    "EPS",
    "DelayFn",
    "constant_delay",
    "uniform_delay",
]

# Minimal spacing between two arrivals on the same FIFO link.  Keeps the
# arrival order on a link identical to the send order even when the delay
# function is time-varying or jittered (FIFO discipline).
EPS = 1e-9


@dataclass
class Link:
    """A directed FIFO communication link ``src -> dst``."""

    src: int
    dst: int
    delay_fn: DelayFn
    # Arrival time of the last message scheduled on this link; successors
    # must arrive strictly after it (FIFO).
    last_arrival: float = -1.0
    # Messages scheduled but not yet received (event ids).  Used to drop
    # in-flight traffic when the link is removed.
    in_flight: int = 0
    alive: bool = True


class Network:
    """Deterministic event-driven network of protocol processes.

    Protocol instances are registered with :meth:`add_process` and must
    implement the callbacks ``on_receive(src, msg)``, ``on_oob(src, msg)``,
    ``on_open(q)``, ``on_close(q)`` and ``on_timeout(payload)`` (see
    ``core.base.Protocol``).
    """

    def __init__(
        self,
        seed: int = 0,
        default_delay: DelayFn | float = 1.0,
        oob_delay: DelayFn | float | None = None,
        oob_loss: float = 0.0,
    ) -> None:
        self.rng = random.Random(seed)
        self.time: float = 0.0
        self._queue: List[Tuple[float, int, Tuple]] = []
        self._seq = itertools.count()
        self.procs: Dict[int, Any] = {}
        self.links: Dict[Tuple[int, int], Link] = {}
        self.out: Dict[int, List[int]] = {}  # src -> [dst] (alive links)
        if not callable(default_delay):
            default_delay = constant_delay(float(default_delay))
        self.default_delay: DelayFn = default_delay
        if oob_delay is None:
            oob_delay = default_delay
        elif not callable(oob_delay):
            oob_delay = constant_delay(float(oob_delay))
        self.oob_delay: DelayFn = oob_delay
        self.oob_loss = float(oob_loss)
        self.stats = NetStats()
        # Event trace for the oracle: list of (time, kind, pid, data).
        self.trace: List[Tuple[float, str, int, Any]] = []
        self.trace_enabled = True

    # ------------------------------------------------------------------ #
    # Topology management
    # ------------------------------------------------------------------ #
    def add_process(self, proc: Any) -> None:
        assert proc.pid not in self.procs, f"duplicate pid {proc.pid}"
        self.procs[proc.pid] = proc
        self.out.setdefault(proc.pid, [])
        proc.net = self

    def has_link(self, a: int, b: int) -> bool:
        lk = self.links.get((a, b))
        return lk is not None and lk.alive

    def connect(self, a: int, b: int, delay: DelayFn | float | None = None,
                bidirectional: bool = False) -> None:
        """Add the directed link ``a -> b`` and notify ``a`` (paper: open(q))."""
        if self.has_link(a, b):
            return
        if delay is None:
            delay_fn = self.default_delay
        elif not callable(delay):
            delay_fn = constant_delay(float(delay))
        else:
            delay_fn = delay
        lk = self.links.get((a, b))
        if lk is None:
            lk = Link(a, b, delay_fn)
            self.links[(a, b)] = lk
        else:  # resurrect a removed link
            lk.alive = True
            lk.delay_fn = delay_fn
            lk.last_arrival = self.time
        self.out[a].append(b)
        self._record("open", a, b)
        self.procs[a].on_open(b)
        if bidirectional:
            self.connect(b, a, delay=delay, bidirectional=False)

    def disconnect(self, a: int, b: int, bidirectional: bool = False) -> None:
        """Remove the link ``a -> b``; in-flight messages on it are dropped."""
        lk = self.links.get((a, b))
        if lk is not None and lk.alive:
            lk.alive = False
            self.out[a].remove(b)
            self._record("close", a, b)
            self.procs[a].on_close(b)
        if bidirectional:
            self.disconnect(b, a, bidirectional=False)

    def crash(self, pid: int) -> None:
        """Crash a process: it stops reacting; its links die silently
        (neighbors are NOT notified — Fig. 5b's silent-departure scenario
        corresponds to crashing without disconnecting)."""
        self.procs[pid].crashed = True
        self._record("crash", pid, None)

    def depart(self, pid: int) -> None:
        """Graceful departure: remove all incident links, then crash."""
        for (a, b), lk in list(self.links.items()):
            if lk.alive and (a == pid or b == pid):
                self.disconnect(a, b)
        self.crash(pid)

    def neighbors(self, pid: int) -> List[int]:
        return list(self.out.get(pid, ()))

    # ------------------------------------------------------------------ #
    # Messaging
    # ------------------------------------------------------------------ #
    def send(self, src: int, dst: int, msg: Any) -> None:
        """Send ``msg`` over the FIFO link ``src -> dst``."""
        lk = self.links.get((src, dst))
        if lk is None or not lk.alive:
            return  # link vanished under the sender; message lost
        delay = max(0.0, lk.delay_fn(self.time, self.rng))
        arrival = max(self.time + delay, lk.last_arrival + EPS)
        lk.last_arrival = arrival
        lk.in_flight += 1
        self.stats.sent_messages += 1
        self._push(arrival, ("recv", src, dst, msg))

    def send_oob(self, src: int, dst: int, msg: Any) -> None:
        """Out-of-band unicast (pong replies): any channel, possibly lossy,
        NOT FIFO with respect to link traffic."""
        self.stats.oob_messages += 1
        if self.oob_loss > 0.0 and self.rng.random() < self.oob_loss:
            return  # lost
        delay = max(0.0, self.oob_delay(self.time, self.rng))
        self._push(self.time + delay, ("oob", src, dst, msg))

    def set_timeout(self, pid: int, delay: float, payload: Any) -> None:
        self._push(self.time + delay, ("timeout", pid, payload))

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        self._push(self.time + delay, ("call", fn))

    # ------------------------------------------------------------------ #
    # Event loop
    # ------------------------------------------------------------------ #
    def _push(self, t: float, ev: Tuple) -> None:
        heapq.heappush(self._queue, (t, next(self._seq), ev))

    def _record(self, kind: str, pid: int, data: Any) -> None:
        if self.trace_enabled:
            self.trace.append((self.time, kind, pid, data))

    def record_delivery(self, pid: int, msg: Any) -> None:
        """Called by protocols on app-message delivery (oracle hook)."""
        self.stats.deliveries += 1
        self._record("deliver", pid, msg)

    def record_broadcast(self, pid: int, msg: Any) -> None:
        self._record("broadcast", pid, msg)

    def run(self, until: float = float("inf"), max_events: int = 100_000_000) -> int:
        """Run the simulation until the queue is empty or ``until`` is hit.
        Returns the number of processed events."""
        n = 0
        while self._queue and n < max_events:
            t, _, ev = self._queue[0]
            if t > until:
                break
            heapq.heappop(self._queue)
            self.time = max(self.time, t)
            kind = ev[0]
            if kind == "recv":
                _, src, dst, msg = ev
                lk = self.links.get((src, dst))
                if lk is not None:
                    lk.in_flight -= 1
                    if not lk.alive:
                        n += 1
                        continue  # dropped with the link
                proc = self.procs.get(dst)
                if proc is not None and not getattr(proc, "crashed", False):
                    proc.on_receive(src, msg)
            elif kind == "oob":
                _, src, dst, msg = ev
                proc = self.procs.get(dst)
                if proc is not None and not getattr(proc, "crashed", False):
                    proc.on_oob(src, msg)
            elif kind == "timeout":
                _, pid, payload = ev
                proc = self.procs.get(pid)
                if proc is not None and not getattr(proc, "crashed", False):
                    proc.on_timeout(payload)
            elif kind == "call":
                ev[1]()
            n += 1
        if self._queue and n < max_events:
            self.time = until if until != float("inf") else self.time
        return n

    def idle(self) -> bool:
        return not self._queue
