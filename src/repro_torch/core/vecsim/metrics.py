"""Oracle bridges for the port's engine results.

  * ``build_trace``        — reconstructs an event trace compatible with
    ``core.oracle.check_trace`` from the delivery matrix, so the
    happens-before oracle validates engine runs unchanged;
  * ``delivered_multiset`` — the canonical (pid, origin, counter)
    delivery multiset used for byte-level cross-validation.

Within-round delivery order is not modeled by the lockstep engine; the
trace orders same-round deliveries by message slot, which is consistent
with causality because a causal predecessor always occupies an earlier
slot (broadcast schedules are round-sorted and a message cannot depend
on a same-round broadcast of another origin).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..base import AppMsg
from .scenario import VecScenario

__all__ = ["build_trace", "delivered_multiset"]


def _app_msgs(scn: VecScenario) -> List[AppMsg]:
    counters = scn.msg_counters()
    return [AppMsg(int(o), int(c))
            for o, c in zip(scn.bcast_origin, counters)]


def build_trace(res) -> List[Tuple[float, str, int, AppMsg]]:
    """Oracle-compatible trace: per round, broadcasts first (the lockstep
    broadcast phase precedes the arrival-delivery phase), then deliveries
    ordered by message slot.  Accepts monolithic and windowed results —
    the latter must have collected the full delivered matrix
    (``collect="full"``)."""
    if res.delivered is None:
        raise ValueError("trace reconstruction needs the full delivered "
                         "matrix; rerun the windowed engine with "
                         "collect='full'")
    scn = res.scenario
    msgs = _app_msgs(scn)
    d_app = res.delivered[:, : scn.m_app]
    events = []
    for i in range(scn.m_app):
        t = int(scn.bcast_round[i])
        o = int(scn.bcast_origin[i])
        # a broadcast happened iff its origin delivered it (an origin that
        # crashed before its scheduled round never broadcast the message)
        if res.delivered[o, i] >= 0:
            events.append(((t, 0, i, -1), "broadcast", o, msgs[i]))
    pids, slots = np.nonzero(d_app >= 0)
    for p, i in zip(pids.tolist(), slots.tolist()):
        t = int(d_app[p, i])
        events.append(((t, 1, i, p), "deliver", p, msgs[i]))
    events.sort(key=lambda ev: ev[0])
    return [(float(key[0]), kind, pid, m) for key, kind, pid, m in events]


def delivered_multiset(res) -> List[Tuple[int, int, int]]:
    """Sorted (pid, origin, counter) triples over all app deliveries."""
    if res.delivered is None:
        raise ValueError("delivered multiset needs the full delivered "
                         "matrix; rerun the windowed engine with "
                         "collect='full'")
    scn = res.scenario
    counters = scn.msg_counters()
    d_app = res.delivered[:, : scn.m_app]
    pids, slots = np.nonzero(d_app >= 0)
    out = [(int(p), int(scn.bcast_origin[i]), int(counters[i]))
           for p, i in zip(pids.tolist(), slots.tolist())]
    out.sort()
    return out
