"""Algorithm 1 — R-broadcast (uniform reliable broadcast by flooding).

Line-faithful implementation of the paper's Algorithm 1: each process keeps
its neighborhood ``Q`` and a ``received`` set; on first receipt it forwards
the message on **all** outgoing links and delivers it.  Over FIFO links and a
*static* overlay this is causal (Theorem 1, Friedman-Manor); over a dynamic
overlay it may violate causal order (Fig. 3) — which our tests demonstrate.

Method map (paper, Algorithm 1):

  ``__init__``        INITIALLY lines 1-3: ``Q`` <- neighborhood,
                      ``received`` <- empty set
  ``broadcast``       function R-broadcast(m), lines 4-7:
                      received <- received U m; foreach q in Q: sendTo(q, m);
                      R-deliver(m)
  ``on_receive``      upon receive(m), lines 8-12: first receipt only —
                      received <- received U m; forward to every q in Q;
                      R-deliver(m)
  ``on_open/on_close``the membership layer's open(q)/close(q) signals:
                      Q <- Q U q / Q \\ q.  R-broadcast uses a link the
                      moment it exists — exactly what breaks causal order
                      under dynamicity (Fig. 3) and what Algorithm 2 gates.
  ``r_deliver``       R-deliver(m); PC-broadcast (Algorithm 2) overrides
                      this hook to buffer into unsafe links first.

``prune_received`` implements the paper's §6 future-work item for *static*
networks (received-set space reclamation; see the class docstring).
"""

from __future__ import annotations

from typing import Any, Set, Tuple

from .base import AppMsg, Ping, Pong, Protocol, msg_id

__all__ = ["RBroadcast"]


class RBroadcast(Protocol):
    """Algorithm 1.  ``Q`` = neighborhood, ``received`` = seen message ids.

    ``prune_received`` implements the paper's §6 future-work item for
    *static* networks: every process eventually receives exactly
    ``in_degree`` copies of each message (one per incoming link under
    flooding), so once that count is reached the id can be reclaimed —
    received-set space becomes O(in-flight) instead of O(N).  Unsafe
    under dynamic membership (the paper says so; we only enable it on
    static overlays)."""

    def __init__(self, pid: int, deliver_cb=None, prune_received=False):
        super().__init__(pid, deliver_cb)
        self.Q: Set[int] = set()                      # p's neighborhood
        self.received: Set[Tuple[int, int]] = set()   # received message ids
        self.prune_received = prune_received
        self._receipts: dict = {}                     # id -> copies seen
        self.pruned = 0

    # -- membership ------------------------------------------------------ #
    def on_open(self, q: int) -> None:
        # R-broadcast uses every link as soon as it exists (no safety gate):
        # this is exactly what makes it violate causal order under dynamicity.
        self.Q.add(q)

    def on_close(self, q: int) -> None:
        self.Q.discard(q)

    # -- dissemination (Algorithm 1) -------------------------------------- #
    def broadcast(self, payload: Any = None) -> AppMsg:
        """function R-broadcast(m)"""
        m = self.next_message(payload)
        self.net.record_broadcast(self.pid, m)
        self.received.add(msg_id(m))                 # received <- received U m
        for q in list(self.Q):                       # foreach q in Q: sendTo
            self.send(q, m)
        self.r_deliver(m)
        return m

    def on_receive(self, src: int, msg: Any) -> None:
        """upon receive(m)"""
        if isinstance(msg, AppMsg):
            mid = msg_id(msg)
            if mid in self.received:                 # if m not in received
                self.net.stats.duplicate_receipts += 1
                self._count_receipt(mid)
                return
            self.received.add(mid)
            self._count_receipt(mid)
            for q in list(self.Q):                   # forward
                self.send(q, msg)
            self.r_deliver(msg)
        elif isinstance(msg, (Ping, Pong)):
            # Plain R-broadcast has no safety machinery; ignore strays.
            pass

    def _count_receipt(self, mid) -> None:
        if not self.prune_received:
            return
        in_deg = sum(1 for (a, b), lk in self.net.links.items()
                     if b == self.pid and lk.alive)
        c = self._receipts.get(mid, 0) + 1
        if c >= in_deg:                     # all copies arrived: reclaim
            self.received.discard(mid)
            self._receipts.pop(mid, None)
            self.pruned += 1
        else:
            self._receipts[mid] = c

    # -- delivery ---------------------------------------------------------- #
    def r_deliver(self, m: AppMsg) -> None:
        """R-deliver(m).  Subclasses (PC-broadcast) hook here."""
        self.deliver(m)
