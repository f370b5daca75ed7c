"""Protocol metrics: safe-graph path lengths, unsafe links, overhead.

These back the Table 1 and Fig. 7 reproductions:
  * ``mean_shortest_path`` — BFS over the *safe-link* graph (PC-broadcast
    excludes links still in their buffering phase, R-broadcast uses all);
  * ``unsafe_link_stats`` — unsafe links / buffered messages per process;
  * ``overhead_per_message`` — control bytes per app message sent.

The port's copy of the JAX package's ``repro.obs.graphs`` (the JAX
package's ``repro.core.metrics`` shim over it is not ported).
"""

from __future__ import annotations

import statistics
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.events import Network

__all__ = [
    "safe_graph",
    "full_graph",
    "mean_shortest_path",
    "unsafe_link_stats",
    "overhead_per_message",
]


def safe_graph(net: Network) -> Dict[int, List[int]]:
    """Adjacency restricted to links the protocol will actually use (Q)."""
    g: Dict[int, List[int]] = {}
    for pid, proc in net.procs.items():
        if getattr(proc, "crashed", False):
            continue
        g[pid] = [q for q in getattr(proc, "Q", ()) if not
                  getattr(net.procs.get(q), "crashed", False)]
    return g


def full_graph(net: Network) -> Dict[int, List[int]]:
    """Adjacency over all alive links regardless of safety."""
    g: Dict[int, List[int]] = {}
    for pid, proc in net.procs.items():
        if getattr(proc, "crashed", False):
            continue
        g[pid] = [q for q in net.neighbors(pid) if not
                  getattr(net.procs.get(q), "crashed", False)]
    return g


def _bfs_depths(g: Dict[int, List[int]], src: int) -> Dict[int, int]:
    depth = {src: 0}
    dq = deque([src])
    while dq:
        u = dq.popleft()
        for v in g.get(u, ()):
            if v not in depth:
                depth[v] = depth[u] + 1
                dq.append(v)
    return depth


def mean_shortest_path(g: Dict[int, List[int]], sources: Sequence[int],
                       unreachable_penalty: Optional[float] = None) -> float:
    """Mean hops from ``sources`` to every reachable process.

    This is the paper's Fig. 7 (top) metric: the expected hop count of a
    broadcast before reaching everyone; x transmission delay = expected
    delivery latency."""
    total, count = 0.0, 0
    for s in sources:
        depth = _bfs_depths(g, s)
        for pid in g:
            if pid == s:
                continue
            d = depth.get(pid)
            if d is None:
                if unreachable_penalty is not None:
                    total += unreachable_penalty
                    count += 1
                continue
            total += d
            count += 1
    return total / count if count else float("nan")


def unsafe_link_stats(net: Network) -> Tuple[float, float, int]:
    """(mean unsafe links/process, mean buffered msgs/process, max buffer)."""
    unsafe, buffered, mx = [], [], 0
    for proc in net.procs.values():
        if getattr(proc, "crashed", False) or not hasattr(proc, "B"):
            continue
        sizes = [len(ent[1]) for ent in proc.B.values()]
        unsafe.append(len(proc.B))
        buffered.append(sum(sizes))
        if sizes:
            mx = max(mx, max(sizes))
    return (
        statistics.fmean(unsafe) if unsafe else 0.0,
        statistics.fmean(buffered) if buffered else 0.0,
        mx,
    )


def overhead_per_message(net: Network) -> float:
    """Mean causality-control bytes per message sent on FIFO links."""
    sent = net.stats.sent_messages
    return net.stats.control_bytes / sent if sent else 0.0
