"""How many rounds a scenario runs: frozen copies of the settle-time rule
of ``repro_torch.core.vecsim.scenario`` (``settle_rounds``) and of the
diameter bound it is given (``diameter_bound``).

They are copied, not imported, so that a change to the program can
never change the inputs it is measured on.  Only numpy is used.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["settle_rounds", "diameter_bound"]


def settle_rounds(n: int, k: int, max_delay: int, pong_delay: int = 1,
                  diam: Optional[int] = None) -> int:
    """Rounds after the last scheduled event for a broadcast to flood
    the overlay and every ping phase to resolve."""
    if diam is None:
        diam = math.ceil(math.log(max(n, 2)) / math.log(max(k - 1, 2))) + 3
    return (diam + 2) * max_delay + 2 * pong_delay + 6


def diameter_bound(adj: np.ndarray) -> int:
    """``ecc_out(0) + ecc_in(0)`` of the slot-table graph, an upper
    bound of its directed hop diameter."""
    n, k = adj.shape
    mask = adj >= 0
    src = np.repeat(np.arange(n), k)[mask.ravel()]
    dst = adj.ravel()[mask.ravel()].astype(np.int64)

    def ecc(forward: bool) -> int:
        seen = np.zeros(n, bool)
        frontier = np.zeros(n, bool)
        seen[0] = frontier[0] = True
        hops = 0
        while True:
            cand = dst[frontier[src]] if forward else src[frontier[dst]]
            frontier = np.zeros(n, bool)
            fresh = cand[~seen[cand]]
            if not len(fresh):
                break
            seen[fresh] = frontier[fresh] = True
            hops += 1
        if not seen.all():
            raise ValueError("slot table is not strongly connected")
        return hops

    return ecc(True) + ecc(False)
