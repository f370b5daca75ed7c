"""Algorithm 2 — PC-broadcast (Preventive Causal broadcast).

Extends R-broadcast with *safe links* (Definition 8).  A newly added link is
removed from the dissemination set ``Q`` until a **ping phase** completes
(Definition 9): the ping pi travels over safe links only — behind every
message its sender delivered before it (FIFO) — while the pong rho may come
back over any channel.  Messages delivered during the phase are buffered per
unsafe link (Definition 10) and flushed over the new link on pong receipt,
after which the link joins ``Q`` (Lemma 3).

Ping transport is configurable:
  * ``"flood"`` — pings are disseminated like broadcast messages over safe
    links, deduplicated on (frm, id); maximally faithful to Lemma 2.
  * ``"route"`` — pings follow a shortest path over the current safe-link
    graph, hop by hop over FIFO links (the paper: "We leave aside the
    implementation of this send function (e.g. broadcast or routing)").
    Fig. 7's "at most 3 hops" matches this mode; it is what large
    simulations use.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

from .base import AppMsg, Ping, Pong
from .rbroadcast import RBroadcast

__all__ = ["PCBroadcast"]


class PCBroadcast(RBroadcast):
    """Algorithm 2 at process p.

    ``Q``  — safe outgoing links only (inherited).
    ``B``  — map unsafe link -> (ping counter, buffered delivered messages).
    ``ctrl_counter`` — control message identifier (paper line 4).
    """

    def __init__(self, pid: int, deliver_cb=None, ping_mode: str = "flood",
                 always_gate: bool = False,
                 direct_ping_fallback: bool = False):
        super().__init__(pid, deliver_cb)
        assert ping_mode in ("flood", "route")
        self.ping_mode = ping_mode
        # Paper's Algorithm 2 gates every added link (always_gate=True).
        # Default is a sound fast-path: a process that has DELIVERED nothing
        # yet cannot have messages missing from a new link (Definition 8 is
        # satisfied vacuously — every future delivery is forwarded on the
        # link in FIFO order), so such links are safe on creation.  This is
        # what makes cold bootstrap (building the initial static overlay)
        # ping-free; it never weakens safety and is exercised by the same
        # property tests as the faithful mode.
        self.always_gate = always_gate
        # Fresh-joiner bootstrap (DESIGN.md §2.2): a process whose ONLY
        # links are new has no safe path for inbound pings — the paper's
        # ping phase cannot complete (its model adds links between already
        # -connected processes).  With this flag, a ping with no safe
        # route is sent over the gated link itself.  That is safe exactly
        # when no pre-gate message can still be in flight toward the
        # target — true for fresh joiners whose history arrives by state
        # transfer — so the runtime enables it only on join links.
        self.direct_ping_fallback = direct_ping_fallback
        self.n_delivered = 0
        self.ctrl_counter = 0
        # B: link q -> [buffer_counter, list-of-buffered-msgs]
        self.B: Dict[int, List] = {}
        self._seen_pings: Set[Tuple[int, int]] = set()

    # ------------------------------------------------------------------ #
    # SAFETY (Algorithm 2, lines 6-20)
    # ------------------------------------------------------------------ #
    def on_open(self, q: int) -> None:
        """upon open(q) — the link p->q was just added by the membership
        layer.  If p has other outgoing links the new one may act as a
        shortcut (Fig. 3) and starts *unsafe*; if it is p's sole link there
        is no alternate path to shortcut, and it is used immediately."""
        self.Q.add(q)
        if len(self.Q) > 1 and (self.always_gate or self.n_delivered > 0):
            self._begin_ping_phase(q)

    def _begin_ping_phase(self, q: int) -> None:
        self.ctrl_counter += 1                    # counter <- counter + 1
        self.Q.discard(q)                         # Q <- Q \ q   (unsafe)
        self.B[q] = [self.ctrl_counter, []]       # B[q] <- empty buffer
        self._send_ping(q, self.ctrl_counter)     # ping(p, q, counter)
        self.on_ping_sent(q, self.ctrl_counter)   # Algorithm 3 hook

    def on_ping_sent(self, q: int, ping_id: int) -> None:
        """Hook for Algorithm 3 (retry bookkeeping + timeout)."""

    def _send_ping(self, q: int, ping_id: int) -> None:
        ping = Ping(self.pid, q, ping_id)
        if self.ping_mode == "flood":
            self._seen_pings.add((ping.frm, ping.id))
            for nb in list(self.Q):
                self.send(nb, ping)
        else:
            path = self._safe_route(q)
            if path is None:
                if self.direct_ping_fallback:
                    self.send(q, Ping(self.pid, q, ping_id, route=()))
                return  # else: no safe path now; timeout/retry (Alg. 3)
            self.send(path[0], Ping(self.pid, q, ping_id, route=tuple(path[1:])))

    def _safe_route(self, target: int) -> Optional[List[int]]:
        """BFS shortest path self -> target over the *safe-link* graph.

        The simulator grants routing a topology oracle; a deployment would
        use the overlay's routing service.  The path rides FIFO links hop by
        hop, so Lemma 2's flushing argument is preserved."""
        if target in self.Q:
            return [target]
        procs = self.net.procs
        prev: Dict[int, int] = {self.pid: self.pid}
        dq = deque([self.pid])
        while dq:
            u = dq.popleft()
            proc = procs.get(u)
            if proc is None or getattr(proc, "crashed", False):
                continue
            for v in getattr(proc, "Q", ()):  # safe links only
                if v in prev:
                    continue
                prev[v] = u
                if v == target:
                    path = [v]
                    while path[-1] != self.pid:
                        path.append(prev[path[-1]])
                    path.reverse()
                    return path[1:]  # drop self
                dq.append(v)
        return None

    def on_close(self, q: int) -> None:
        """upon close(q) — drop membership and any pending buffer."""
        self.Q.discard(q)
        self.B.pop(q, None)                       # B <- B \ q

    # ------------------------------------------------------------------ #
    # Control-message handling
    # ------------------------------------------------------------------ #
    def on_receive(self, src: int, msg: Any) -> None:
        if isinstance(msg, Ping):
            self._on_ping(src, msg)
        else:
            super().on_receive(src, msg)

    def _on_ping(self, src: int, ping: Ping) -> None:
        if ping.to == self.pid:
            # upon receivePing(from, to, id): pong(from, to, id).
            # The reply may travel over any communication mean (oob).
            self.net.stats.sent_control += 1
            self.net.send_oob(self.pid, ping.frm, Pong(ping.frm, ping.to, ping.id))
            return
        if self.ping_mode == "flood":
            key = (ping.frm, ping.id)
            if key in self._seen_pings:
                return
            self._seen_pings.add(key)
            for nb in list(self.Q):               # forward over safe links
                self.send(nb, ping)
        else:  # route mode: forward along the precomputed path
            if not ping.route:
                return  # malformed/stale
            nxt, rest = ping.route[0], ping.route[1:]
            if nxt in self.Q or nxt == ping.to and self.net.has_link(self.pid, nxt):
                self.send(nxt, Ping(ping.frm, ping.to, ping.id, route=rest))
            # else: route went stale (link removed) — drop; Alg. 3 retries.

    def on_oob(self, src: int, msg: Any) -> None:
        if isinstance(msg, Pong):
            self._on_pong(msg)

    def _on_pong(self, pong: Pong) -> None:
        """upon receivePong(from, to, id)  — from = p.

        Flush the buffer over the new link, then mark it safe.  Pongs whose
        id does not match the buffer's current counter are stale replies to
        a reset ping phase and are discarded (Fig. 6c)."""
        ent = self.B.get(pong.to)
        if ent is None or ent[0] != pong.id:
            return                                 # no matching buffer
        for m in ent[1]:                           # foreach m in B[to]
            self.send(pong.to, m)                  #   sendTo(to, m)
        del self.B[pong.to]                        # B <- B \ to
        self.Q.add(pong.to)                        # Q <- Q U to   (now safe)
        self.on_link_safe(pong.to, pong.id)        # Algorithm 3 hook

    def on_link_safe(self, q: int, ping_id: int) -> None:
        """Hook for Algorithm 3 (clears retry state)."""

    # ------------------------------------------------------------------ #
    # DISSEMINATION (Algorithm 2, lines 21-26)
    # ------------------------------------------------------------------ #
    # function PC-broadcast(m): R-broadcast(m) — inherited broadcast().

    def r_deliver(self, m: AppMsg) -> None:
        """upon R-deliver(m): buffer into every unsafe link, then deliver."""
        for q in self.B:                           # foreach q in B
            self.B[q][1].append(m)                 #   B[q] <- B[q] U m
        self.n_delivered += 1
        self.deliver(m)                            # PC-deliver(m)
        self.on_pc_deliver(m)                      # Algorithm 3 hook

    def on_pc_deliver(self, m: AppMsg) -> None:
        """Hook for Algorithm 3 (buffer bound check)."""

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #
    @property
    def unsafe_links(self) -> List[int]:
        return list(self.B.keys())

    def buffer_sizes(self) -> Dict[int, int]:
        return {q: len(ent[1]) for q, ent in self.B.items()}
