"""Overlay construction and Spray-like dynamics (paper §4 experiment).

``ring_plus_random`` builds the static bootstrap topology: a directed ring
(guaranteeing strong connectivity, hence Definition 3's unpartitioned
assumption) plus ``k-1`` random extra out-links per process — a close
approximation of the random graphs peer-sampling services converge to.

``SprayOverlay`` drives dynamicity the way the paper describes its
experiment: each process initiates a view exchange once per ``period``
(so each neighborhood changes at least once, and on average twice, per
period), and each exchange makes both participants drop half of their
partial view and adopt the other half from their partner.  All link churn
flows through ``Network.connect``/``disconnect`` so the protocol under test
sees every ``open``/``close``.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence

from .events import Network

__all__ = ["ring_plus_random", "view_size", "SprayOverlay"]


def view_size(n: int, c: float = 1.0) -> int:
    """Partial-view size ~ log of the network size (Spray converges to
    ln(N)-sized views; the paper's Fig. 7 runs have ~17 links/process)."""
    return max(2, int(round(c * math.log(max(n, 2)) + 1)))


def ring_plus_random(net: Network, pids: Sequence[int], k: Optional[int] = None,
                     rng: Optional[random.Random] = None) -> None:
    """Connect ``pids`` in a directed ring plus ``k-1`` random out-links."""
    rng = rng or net.rng
    n = len(pids)
    k = k if k is not None else view_size(n)
    for i, p in enumerate(pids):
        net.connect(p, pids[(i + 1) % n])
        extra = 0
        while extra < k - 1 and n > 2:
            q = pids[rng.randrange(n)]
            if q != p and not net.has_link(p, q):
                net.connect(p, q)
                extra += 1


class SprayOverlay:
    """Periodic half-view exchanges between random neighbor pairs."""

    def __init__(self, net: Network, pids: Sequence[int], period: float = 60.0,
                 rng: Optional[random.Random] = None):
        self.net = net
        self.pids = list(pids)
        self.period = period
        self.rng = rng or net.rng
        self.exchanges = 0
        self.links_added = 0
        self.links_removed = 0
        self._running = False

    def start(self) -> None:
        self._running = True
        for p in self.pids:
            # Desynchronize first exchanges uniformly over one period.
            self.net.call_later(self.rng.uniform(0, self.period),
                                lambda p=p: self._tick(p))

    def stop(self) -> None:
        self._running = False

    def _tick(self, p: int) -> None:
        if not self._running:
            return
        proc = self.net.procs.get(p)
        if proc is not None and not getattr(proc, "crashed", False):
            self.exchange(p)
        self.net.call_later(self.period, lambda: self._tick(p))

    def exchange(self, p: int) -> None:
        """One Spray-style exchange initiated by ``p`` with a random
        neighbor ``q``: both shed half their view and adopt the peer's
        shed half (paper: "both add and remove half of their partial
        view")."""
        out_p = [x for x in self.net.neighbors(p)]
        if not out_p:
            return
        q = self.rng.choice(out_p)
        proc_q = self.net.procs.get(q)
        if proc_q is None or getattr(proc_q, "crashed", False):
            return
        out_q = [x for x in self.net.neighbors(q)]

        give_p = self._half(out_p, exclude={q})
        give_q = self._half(out_q, exclude={p})

        self._apply(p, remove=give_p, add=give_q)
        self._apply(q, remove=give_q, add=give_p)
        self.exchanges += 1

    def _half(self, view: List[int], exclude=frozenset()) -> List[int]:
        cand = [x for x in view if x not in exclude]
        self.rng.shuffle(cand)
        return cand[: max(1, len(cand) // 2)] if cand else []

    def _apply(self, p: int, remove: List[int], add: List[int]) -> None:
        current = set(self.net.neighbors(p))
        for x in add:
            if x != p and x not in current:
                proc_x = self.net.procs.get(x)
                if proc_x is None or getattr(proc_x, "crashed", False):
                    continue
                self.net.connect(p, x)
                current.add(x)
                self.links_added += 1
        for x in remove:
            # Keep at least 2 out-links so flooding connectivity survives
            # (the paper assumes churn never partitions the overlay).
            if len(current) <= 2:
                break
            if self.net.has_link(p, x):
                self.net.disconnect(p, x)
                current.discard(x)
                self.links_removed += 1
