"""Vector-clock causal broadcast — the paper's Table 1 baseline.

Classic Fidge/Mattern causality tracking over a gossip overlay: every
broadcast message piggybacks the sender's full vector clock (O(N) control
bytes, N = processes that ever broadcast); receivers delay out-of-order
messages in a pending set and re-scan it after every delivery — the
O(W·N) delivery execution time Table 1 charges this family with.

Unlike PC-broadcast it needs neither FIFO links nor link-safety gating, so
it tolerates dynamic overlays out of the box — at the price of overhead
that grows with the fleet.  ``comparisons`` counts vector-entry comparisons
so benchmarks can expose the W·N behaviour directly.

Method map (classic causal broadcast, the family Table 1's first row
summarizes; there is no paper algorithm listing for the baseline):

  ``broadcast``             stamp the message with the local clock
                            (sender entry pre-incremented), gossip it to
                            the current view, deliver immediately — the
                            O(N) piggyback Table 1 charges per message
  ``on_receive``            gossip-forward on first receipt (dedup on
                            message id), then park in ``pending`` (W)
  ``_ready``                the delivery condition: every clock entry
                            satisfied, sender entry off by exactly one —
                            one O(N) scan per check
  ``_drain``                re-scan pending after every delivery until a
                            fixpoint: the O(W·N) delivery execution time
  ``local_space_entries``   Table 1's local-space metric: clock entries
                            plus the clocks of parked messages

The vectorized twin of this protocol (``core.vecsim.vc``) runs the
same semantics as dense tensors on the card at large N; its delivered
multisets and final clock values are cross-validated byte-identical
against this class on the exact engine (``cross_validate(...,
protocol="vc")``).  The older analytic approximation
(``vecsim.vc_overhead_model``) is kept for contrast.

The port's copy of the JAX package's ``repro.core.vector_clock``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Set, Tuple

from .base import AppMsg, Protocol, msg_id

__all__ = ["VCBroadcast"]


class VCBroadcast(Protocol):
    def __init__(self, pid: int, deliver_cb=None):
        super().__init__(pid, deliver_cb)
        self.Q: Set[int] = set()
        self.vc: Dict[int, int] = {}                 # pid -> delivered count
        self.pending: List[AppMsg] = []              # W: awaiting delivery
        self.received: Set[Tuple[int, int]] = set()  # gossip dedup
        self.comparisons = 0                         # delivery-time metric
        self.max_pending = 0

    # -- membership: every link is usable immediately -------------------- #
    def on_open(self, q: int) -> None:
        self.Q.add(q)

    def on_close(self, q: int) -> None:
        self.Q.discard(q)

    # -- dissemination ----------------------------------------------------- #
    def broadcast(self, payload: Any = None) -> AppMsg:
        self.counter += 1
        ts = dict(self.vc)
        ts[self.pid] = ts.get(self.pid, 0) + 1
        m = AppMsg(self.pid, self.counter, payload, vc=tuple(sorted(ts.items())))
        self.net.record_broadcast(self.pid, m)
        self.received.add(msg_id(m))
        for q in list(self.Q):
            self.send(q, m)
        self.vc[self.pid] = ts[self.pid]
        self.deliver(m)
        return m

    def on_receive(self, src: int, msg: Any) -> None:
        if not isinstance(msg, AppMsg):
            return
        if msg_id(msg) in self.received:
            self.net.stats.duplicate_receipts += 1
            return
        self.received.add(msg_id(msg))
        for q in list(self.Q):                       # gossip forward
            self.send(q, msg)
        self.pending.append(msg)
        self.max_pending = max(self.max_pending, len(self.pending))
        self._drain()

    # -- causal delivery --------------------------------------------------- #
    def _ready(self, m: AppMsg) -> bool:
        ts = dict(m.vc)
        for k, v in ts.items():
            self.comparisons += 1
            have = self.vc.get(k, 0)
            need = v - 1 if k == m.origin else v
            if have < need:
                return False
        return True

    def _drain(self) -> None:
        """Re-scan pending after each delivery: the O(W·N) loop."""
        progress = True
        while progress:
            progress = False
            for m in list(self.pending):
                if self._ready(m):
                    self.pending.remove(m)
                    self.vc[m.origin] = self.vc.get(m.origin, 0) + 1
                    self.deliver(m)
                    progress = True

    # -- metrics ----------------------------------------------------------- #
    def local_space_entries(self) -> int:
        """Vector entries + pending-message vector entries (Table 1 space)."""
        return len(self.vc) + sum(len(m.vc) for m in self.pending)
