"""Cross-validation harness: one scenario, two engines, same deliveries.

``run_exact`` replays a :class:`VecScenario` event-by-event on the exact
discrete-event simulator (``core.events.Network`` driving the
paper-faithful ``PCBroadcast``/``RBroadcast``/``VCBroadcast``
processes, on the host), mapping

  * one lockstep round              -> one unit of simulated time,
  * a slot's integer delay          -> a constant link delay,
  * the scenario's add/rm/crash/broadcast schedule -> ``call_later``
    callbacks registered in phase order (removals, additions, crashes,
    broadcasts) so same-timestamp events fire in the lockstep engine's
    phase order (setup-registered callbacks outrank in-flight arrivals
    in the event heap's tie-break).

``cross_validate`` then runs a vectorized engine of the port on the
device (the card unless ``"cpu"`` is asked for) and the exact replay to
quiescence, and compares the (pid, origin, counter) delivered-message
multisets byte-for-byte, plus happens-before oracle reports on both
traces.  Equality of the multisets is a strong end-to-end check: it
requires both engines to agree on which broadcasts happened, which
processes were reachable, and that neither lost or duplicated a
delivery — while leaving the engines free to differ in sub-round
timing, which the lockstep model deliberately does not reproduce.

The port's copy of the JAX package's ``repro.core.vecsim.crossval``,
with ``device`` in the place of ``backend``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ...obs.graphs import full_graph, safe_graph, unsafe_link_stats
from ..events import Network
from ..oracle import check_trace
from ..pcbroadcast import PCBroadcast
from ..rbroadcast import RBroadcast
from ..vector_clock import VCBroadcast
from .metrics import build_trace, delivered_multiset
from .scenario import VecScenario
from .sim import execute_vec
from .stream import execute_windowed
from .vc import run_vec_vc

__all__ = ["run_exact", "delivered_multiset_exact", "final_clocks_exact",
           "cross_validate"]


def run_exact(scn: VecScenario, seed: int = 0,
              protocol: Optional[str] = None,
              snapshot_round: Optional[int] = None) -> Network:
    """Replay ``scn`` on the exact event simulator and run to quiescence.

    ``protocol`` — ``"pc"``/``"r"``/``"vc"``; defaults to ``scn.mode``.
    ``"vc"`` runs the vector-clock baseline (``core.vector_clock``), for
    which the link-safety schedule fields are plain topology changes.

    ``snapshot_round`` — capture the Fig. 7 graph metrics right after
    that round (at sim time ``snapshot_round + 0.5``, i.e. after every
    integer-time event of the round) onto ``net.snapshot_graphs``:
    ``{"safe": .., "full": .., "unsafe": unsafe_link_stats tuple}`` —
    the exact-engine twin of the vec engines' state snapshot."""
    protocol = scn.mode if protocol is None else protocol
    net = Network(seed=seed, default_delay=1.0,
                  oob_delay=float(scn.pong_delay))
    for pid in range(scn.n):
        if protocol == "pc":
            proc = PCBroadcast(pid, ping_mode="flood",
                               always_gate=scn.always_gate)
        elif protocol == "vc":
            proc = VCBroadcast(pid)
        elif protocol == "r":
            proc = RBroadcast(pid)
        else:
            raise ValueError(f"unknown protocol {protocol!r}")
        net.add_process(proc)
    for p in range(scn.n):
        for kk in range(scn.k):
            q = int(scn.adj0[p, kk])
            if q >= 0:
                net.connect(p, q, delay=float(scn.delay0[p, kk]))

    # Replay slot occupancy so each vec slot removal maps to the one
    # (p, q) link it deactivates at that point in time.
    slot_target = scn.adj0.astype(np.int64).copy()
    slot_active = scn.adj0 >= 0

    def do_broadcast(o: int) -> None:
        proc = net.procs[o]
        if not proc.crashed:
            proc.broadcast()

    events = sorted(
        [(int(t), 0, e) for e, t in enumerate(scn.rm_round)]
        + [(int(t), 1, e) for e, t in enumerate(scn.add_round)]
        + [(int(t), 2, e) for e, t in enumerate(scn.crash_round)]
        + [(int(t), 3, i) for i, t in enumerate(scn.bcast_round)],
        key=lambda ev: (ev[0], ev[1], ev[2]))
    for t, phase, e in events:
        if phase == 0:
            p, kk = int(scn.rm_p[e]), int(scn.rm_k[e])
            if slot_active[p, kk]:
                q = int(slot_target[p, kk])
                slot_active[p, kk] = False
                net.call_later(float(t), lambda p=p, q=q: net.disconnect(p, q))
        elif phase == 1:
            p, kk, q = (int(scn.add_p[e]), int(scn.add_k[e]),
                        int(scn.add_q[e]))
            d = float(scn.add_delay[e])
            slot_target[p, kk] = q
            slot_active[p, kk] = True
            net.call_later(float(t),
                           lambda p=p, q=q, d=d: net.connect(p, q, delay=d))
        elif phase == 2:
            pid = int(scn.crash_pid[e])
            net.call_later(float(t), lambda pid=pid: net.crash(pid))
        else:
            net.call_later(float(t), lambda o=int(scn.bcast_origin[e]):
                           do_broadcast(o))
    if snapshot_round is not None:
        def capture():
            net.snapshot_graphs = dict(safe=safe_graph(net),
                                       full=full_graph(net),
                                       unsafe=unsafe_link_stats(net))
        net.call_later(float(snapshot_round) + 0.5, capture)
    net.run()
    assert net.idle(), "exact replay did not quiesce"
    return net


def delivered_multiset_exact(net: Network) -> List[Tuple[int, int, int]]:
    """Sorted (pid, origin, counter) triples from the exact engine's logs."""
    out = [(pid, m.origin, m.counter)
           for pid, proc in net.procs.items()
           for m in proc.delivered_log]
    out.sort()
    return out


def final_clocks_exact(net: Network) -> List[Dict[int, int]]:
    """Per-process ``VCBroadcast.vc`` dicts (pid order) from an exact
    vector-clock replay, for byte-level clock cross-validation."""
    return [dict(net.procs[pid].vc) for pid in sorted(net.procs)]


def cross_validate(scn: VecScenario, seed: int = 0, device=None,
                   window: Optional[int] = None,
                   protocol: Optional[str] = None,
                   vec_result=None) -> Dict[str, object]:
    """Run both engines on ``scn``; return multisets + oracle reports.
    The vec side runs on ``device`` (the card unless ``"cpu"``).
    ``window`` routes it through the streaming windowed engine (with the
    full delivered matrix collected), so windowed execution is
    cross-validated against the exact simulator the same way.
    ``protocol`` defaults to ``scn.mode``; ``"vc"`` cross-validates the
    vectorized vector-clock baseline (``vecsim.vc``) against
    ``core.vector_clock`` — the result then additionally carries
    ``vec_clocks``/``exact_clocks`` (per-process final clock dicts),
    which must be byte-identical.

    ``vec_result`` — a vec-engine result of the *same scenario* already
    in hand (it must carry the full delivered matrix); skips the vec
    re-execution, leaving only the exact replay to run."""
    protocol = scn.mode if protocol is None else protocol
    if vec_result is not None and vec_result.delivered is not None:
        res = vec_result
    elif protocol == "vc":
        if window is not None:
            raise ValueError("the vector-clock vec engine has no windowed "
                             "mode (its buffers are O(N·m_app) already)")
        res = run_vec_vc(scn, device=device)
    elif window is None:
        res = execute_vec(scn, device=device)
    else:
        res = execute_windowed(scn, window, device=device, collect="full")
    net = run_exact(scn, seed=seed, protocol=protocol)
    crashed: Set[int] = set(np.nonzero(res.state["crashed"])[0].tolist())
    vec_rep = check_trace(build_trace(res), crashed=crashed,
                          all_pids=set(range(scn.n)))
    exact_rep = check_trace(net.trace, crashed=crashed,
                            all_pids=set(range(scn.n)))
    out = dict(
        vec=res,
        exact=net,
        vec_multiset=delivered_multiset(res),
        exact_multiset=delivered_multiset_exact(net),
        vec_report=vec_rep,
        exact_report=exact_rep,
    )
    if protocol == "vc":
        out["vec_clocks"] = res.final_clocks()
        out["exact_clocks"] = final_clocks_exact(net)
    return out
