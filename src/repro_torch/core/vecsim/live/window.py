"""Growable :class:`ColumnWindow` for live (open-loop) ingest — the
port's copy of the JAX package's ``repro.core.vecsim.live.window``.

The pre-scripted engines know the whole broadcast schedule up front, so
the base :class:`~repro_torch.core.vecsim.stream.ColumnWindow` views the
scenario arrays directly.  The live serving loop admits traffic
*between* segments instead: this subclass owns a fixed-capacity
append-only broadcast buffer (``bc_round``/``bc_origin`` with fill
pointer ``m_bc``) that the admission policy extends each tick, plus a
``withdraw_unactivated`` rollback that un-admits everything the engine
has not yet activated — the recovery half of the catch-and-defer
backpressure path (an overflow raise leaves the window untouched, the
loop withdraws, requeues and retries with less).

The global message-id space is pre-split at ``capacity``
(``m_app_cap``), so link-addition pings keep stable ids no matter how
many broadcasts end up admitted; withdrawn buffer positions are reused
by later admissions, keeping admitted ids dense in ``[0, m_bc)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..scenario import INF, VecScenario
from ..stream import ColumnWindow

__all__ = ["LiveColumnWindow"]


class LiveColumnWindow(ColumnWindow):
    """A :class:`ColumnWindow` whose broadcast stream grows at runtime.

    ``capacity`` bounds the total broadcasts ever admitted (it sizes the
    id space and the per-message aggregate arrays).  The JAX package's
    window also takes the per-round admission cap, to size its jitted
    schedules; the port's engines take each segment's schedule as it
    is, so the cap stays with the loop.
    """

    mutable_schedule = True

    def __init__(self, scn: VecScenario, window: int, capacity: int,
                 horizon: Optional[int] = None):
        if scn.m_app:
            raise ValueError(
                "live window needs a broadcast-free base scenario "
                f"(got m_app={scn.m_app}); pre-scripted traffic belongs "
                "in batch mode")
        super().__init__(scn, window, horizon=horizon)
        cap = int(capacity)
        if cap < 1:
            raise ValueError("capacity must be >= 1")
        self.m_app_cap = cap
        self.bc_round = np.full(cap, INF, np.int32)
        self.bc_origin = np.full(cap, -1, np.int32)
        self.bc_live_slot = np.full(cap, -1, np.int32)
        self.m_bc = 0

    def append_broadcasts(self, rounds: np.ndarray,
                          origins: np.ndarray) -> np.ndarray:
        """Admit a round-sorted batch of broadcasts; returns their
        global message ids.  The batch must start at or after the last
        admitted round (the activation stream stays sorted) and respect
        capacity; per-(origin, round) uniqueness is the admission
        planner's contract, checked when the admitted schedule is
        exported as a :class:`VecScenario`."""
        k = len(rounds)
        if not k:
            return np.empty(0, np.int64)
        if self.m_bc + k > self.m_app_cap:
            raise ValueError(
                f"admitted broadcasts would exceed capacity "
                f"{self.m_app_cap} ({self.m_bc} + {k})")
        rounds = np.asarray(rounds, np.int32)
        if k > 1 and (np.diff(rounds) < 0).any():
            raise ValueError("admitted batch must be round-sorted")
        if self.m_bc and rounds[0] < self.bc_round[self.m_bc - 1]:
            raise ValueError(
                f"admitted batch starts at round {int(rounds[0])}, "
                f"before the last admitted round "
                f"{int(self.bc_round[self.m_bc - 1])}")
        ids = np.arange(self.m_bc, self.m_bc + k)
        self.bc_round[ids] = rounds
        self.bc_origin[ids] = np.asarray(origins, np.int32)
        self.m_bc += k
        return ids

    def withdraw_unactivated(self) -> Tuple[np.ndarray, np.ndarray]:
        """Un-admit every broadcast the engine has not activated yet;
        returns their ``(rounds, origins)``.  Their buffer positions
        (ids) are recycled by later admissions.  This is a no-op when
        everything admitted is already live."""
        lo = self.next_bc
        n = self.m_bc - lo
        if n <= 0:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        rounds = self.bc_round[lo: self.m_bc].copy()
        origins = self.bc_origin[lo: self.m_bc].copy()
        self.bc_round[lo: self.m_bc] = INF
        self.bc_origin[lo: self.m_bc] = -1
        self.m_bc = lo
        return rounds, origins
