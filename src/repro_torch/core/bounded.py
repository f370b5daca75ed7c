"""Algorithm 3 — bounding buffer sizes and handling network failures.

Extends PC-broadcast with:
  * ``maxSize``  — a bound on each unsafe-link buffer; exceeding it resets
    the ping phase with a fresh counter (Fig. 6), discarding stale pongs;
  * ``maxRetry`` — a bound on phase restarts; past it the link is abandoned
    (``close``), trading it for liveness (the overlay replaces links);
  * timeouts   — lost pongs / silent departures (Fig. 5b-c) trigger retries.

State (paper, Algorithm 3):
  ``I`` — ping id  -> link awaiting that ping's pong,
  ``R`` — link     -> number of retries so far.

Method map (paper, Algorithm 3; hooks are invoked by Algorithm 2's
implementation in ``pcbroadcast.py``):

  ``on_ping_sent``    upon ping(from, to, id), lines 5-9: if to not in R:
                      R[to] <- 0; I[id] <- to; arm the retry timeout
  ``on_link_safe``    upon receiveAck(from, to, id), lines 10-12:
                      I <- I \\ id ; R <- R \\ to  (stale pongs never get
                      here — Algorithm 2 drops them on the buffer-counter
                      mismatch, Fig. 6c)
  ``on_pc_deliver``   upon PC-deliver(m), lines 13-16: any buffer with
                      |B[q]| > maxSize resets its phase via retry(q)
  ``retry``           function retry(q), lines 17-25: drop pending ping
                      ids for q; R[q] += 1; re-open the phase (fresh
                      counter + empty buffer) while R[q] <= maxRetry,
                      else close(q) and let the overlay replace the link
  ``on_timeout``      HANDLING FAILURES, lines 26-28: a ping whose id is
                      still in I when the timer fires lost its pong
                      (Fig. 5b-c) -> retry(to)
  ``on_close``        upon close(q): clear B[q] (Alg. 2) plus I/R entries
"""

from __future__ import annotations

from typing import Any, Dict

from .base import AppMsg
from .pcbroadcast import PCBroadcast

__all__ = ["BoundedPCBroadcast"]


class BoundedPCBroadcast(PCBroadcast):
    def __init__(
        self,
        pid: int,
        deliver_cb=None,
        ping_mode: str = "flood",
        always_gate: bool = False,
        direct_ping_fallback: bool = False,
        max_size: float = float("inf"),
        max_retry: float = float("inf"),
        ping_timeout: float = float("inf"),
    ):
        super().__init__(pid, deliver_cb, ping_mode, always_gate,
                         direct_ping_fallback)
        self.max_size = max_size
        self.max_retry = max_retry
        self.ping_timeout = ping_timeout
        self.I: Dict[int, int] = {}   # ping id -> link
        self.R: Dict[int, int] = {}   # link -> retries
        self.gave_up: list[int] = []  # links closed after maxRetry (stats)

    # ------------------------------------------------------------------ #
    # BOUNDING BUFFERS (Algorithm 3)
    # ------------------------------------------------------------------ #
    def on_ping_sent(self, q: int, ping_id: int) -> None:
        """upon ping(from, to, id): register retry state + arm a timeout."""
        if q not in self.R:                        # if q not in R: R[q] <- 0
            self.R[q] = 0
        self.I[ping_id] = q                        # I[id] <- to
        if self.ping_timeout != float("inf"):
            self.net.set_timeout(self.pid, self.ping_timeout,
                                 ("ping", q, ping_id))

    def on_link_safe(self, q: int, ping_id: int) -> None:
        """upon receiveAck(from, to, id): I <- I \\ id ; R <- R \\ to.

        (Stale pongs never reach here: PCBroadcast discards them on the
        buffer-counter mismatch, matching Fig. 6c.)"""
        self.I.pop(ping_id, None)
        self.R.pop(q, None)

    def on_pc_deliver(self, m: AppMsg) -> None:
        """upon PC-deliver(m): reset any buffer past its bound."""
        over = [q for q, ent in self.B.items() if len(ent[1]) > self.max_size]
        for q in over:                             # |B[q]| > maxSize
            self.retry(q)

    def on_close(self, q: int) -> None:
        """upon close(q): drop buffer (Alg. 2) and retry state (Alg. 3)."""
        super().on_close(q)
        for i in [i for i, lk in self.I.items() if lk == q]:
            del self.I[i]                          # I <- I \ i
        self.R.pop(q, None)                        # R <- R \ q

    def retry(self, q: int) -> None:
        """function retry(q)."""
        for i in [i for i, lk in self.I.items() if lk == q]:
            del self.I[i]
        if q in self.R:
            self.R[q] += 1
            if self.R[q] <= self.max_retry:
                # Paper: open(q).  The link is already gated (not in Q), so
                # re-run the ping-phase body directly: fresh counter, fresh
                # (empty) buffer, fresh ping.  Stale pongs are discarded by
                # the counter check.
                self._begin_ping_phase(q)
            else:
                # Give up on the link entirely (paper: close(q)).  The
                # overlay's dynamicity replaces abandoned links over time.
                self.gave_up.append(q)
                self.net.disconnect(self.pid, q)

    # ------------------------------------------------------------------ #
    # HANDLING FAILURES (Algorithm 3, lines 26-28)
    # ------------------------------------------------------------------ #
    def on_timeout(self, payload: Any) -> None:
        kind, q, ping_id = payload
        if kind == "ping" and ping_id in self.I:   # if id in I: retry(to)
            self.retry(q)
