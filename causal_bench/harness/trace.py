"""The device trace of a measured window, and what the harness reads
from it.

``torch.profiler`` records the card's activity (CUPTI: kernels, copies,
fills) over the window; the host's own work is not recorded, so the
profiler costs the host about a callback a launch.  Its timestamps are
unix nanoseconds, the clock of ``time.time_ns``; the program's spans
are taken on ``time.monotonic_ns`` and are moved onto that clock by the
offset between the two read at the window's start.

:class:`DeviceTrace` holds the activity as arrays and gives the busy
time (the union of the activity intervals inside the window), the
kernel time and launches of a kernel family, the operations that took
most time, and the idle gaps, each named by the innermost host span
that was open at its midpoint.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["Profiler", "DeviceTrace", "clock_offset_ns", "label_timeline",
           "idle_by_label"]


def clock_offset_ns() -> int:
    """``time.time_ns() - time.monotonic_ns()``, the least of a few
    reads (the one least delayed between the two calls)."""
    best = None
    for _ in range(5):
        m0 = time.monotonic_ns()
        w = time.time_ns()
        m1 = time.monotonic_ns()
        cand = (m1 - m0, w - (m0 + m1) // 2)
        best = cand if best is None or cand < best else best
    return best[1]


@dataclass
class DeviceTrace:
    """Device activity inside ``[t0_ns, t1_ns]`` (unix ns)."""

    t0_ns: int
    t1_ns: int
    names: List[str]          # distinct activity names
    name_id: np.ndarray       # (E,) int32 index into names
    start_ns: np.ndarray      # (E,) int64
    dur_ns: np.ndarray        # (E,) int64
    is_kernel: np.ndarray     # (E,) bool: not a copy or a fill

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Merged activity intervals, clipped to the window."""
        s = np.clip(self.start_ns, self.t0_ns, self.t1_ns)
        e = np.clip(self.start_ns + self.dur_ns, self.t0_ns, self.t1_ns)
        keep = e > s
        s, e = s[keep], e[keep]
        if not len(s):
            return s, e
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = np.maximum.reduceat(e, np.nonzero(new)[0])
        return starts, ends

    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) / 1e9

    def gaps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Idle intervals of the window: before, between and after the
        busy intervals."""
        s, e = self.busy_intervals()
        lo = np.concatenate([[self.t0_ns], e])
        hi = np.concatenate([s, [self.t1_ns]])
        keep = hi > lo
        return lo[keep], hi[keep]

    def _match(self, pattern: str) -> np.ndarray:
        rx = re.compile(pattern)
        hit = np.array([bool(rx.search(n)) for n in self.names], bool)
        return hit[self.name_id] if len(self.names) else np.zeros(0, bool)

    def kernel_ns(self, pattern: str) -> Tuple[int, int]:
        """(events, summed ns) of the kernels whose name matches."""
        m = self._match(pattern) & self.is_kernel
        return int(m.sum()), int(self.dur_ns[m].sum())

    def kernels(self) -> int:
        return int(self.is_kernel.sum())

    def top_ops(self, k: int = 10) -> List[list]:
        tot = np.bincount(self.name_id, self.dur_ns.astype(np.float64),
                          len(self.names))
        order = np.argsort(-tot, kind="stable")[:k]
        return [[self.names[i], float(tot[i]) / 1e9] for i in order
                if tot[i] > 0]


def label_timeline(spans: Iterable[Tuple[str, int, int]], outside: str
                   ) -> Tuple[np.ndarray, List[str]]:
    """Cut the host timeline into pieces named by the innermost open span
    (spans nest, as a begin/end stack records them); returns the piece
    starts and their names, ``outside`` where no span is open."""
    evs = []
    for i, (name, t0, t1) in enumerate(spans):
        evs.append((t0, 1, -t1, i, name))
        evs.append((t1, 0, 0, i, name))
    evs.sort()
    starts, labels, stack = [], [], []
    for t, kind, _, i, name in evs:
        if kind == 1:
            stack.append(name)
        elif stack:
            stack.pop()
        starts.append(t)
        labels.append(stack[-1] if stack else outside)
    return np.asarray(starts, np.int64), labels


def idle_by_label(trace: DeviceTrace, spans: Sequence[Tuple[str, int, int]],
                  outside: str, k: int = 10) -> List[list]:
    """Idle seconds of the window summed by the innermost host span open
    at each gap's midpoint, the largest ``k``."""
    lo, hi = trace.gaps()
    if not len(lo):
        return []
    starts, labels = label_timeline(spans, outside)
    mid = (lo + hi) // 2
    at = np.searchsorted(starts, mid, side="right") - 1
    names = np.array(labels + [outside], dtype=object)
    lab = names[np.where(at >= 0, at, len(labels))]
    out = {}
    for name, d in zip(lab.tolist(), (hi - lo).tolist()):
        out[name] = out.get(name, 0) + d
    top = sorted(out.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in top]


class Profiler:
    """``torch.profiler`` over the card's activity only; :meth:`warm`
    pays its first start (the CUPTI set-up, seconds) in the set-up."""

    def __init__(self, torch):
        self._torch = torch
        self._prof = None
        self.t0_ns = self.t1_ns = 0

    def _new(self):
        prof = self._torch.profiler
        return prof.profile(activities=[prof.ProfilerActivity.CUDA])

    def warm(self, device) -> None:
        with self._new():
            self._torch.ones(1, device=device).add_(1)
            self._torch.cuda.synchronize()

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof = self._new()
        self._prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.stop()

    def trace(self) -> DeviceTrace:
        cuda = self._torch.autograd.DeviceType.CUDA
        ids, names = {}, []
        nid, st, du, ker = [], [], [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            name = e.name()
            i = ids.get(name)
            if i is None:
                i = ids[name] = len(names)
                names.append(name)
            nid.append(i)
            st.append(e.start_ns())
            du.append(e.duration_ns())
            ker.append(not name.startswith(("Memcpy", "Memset")))
        self._prof = None
        return DeviceTrace(self.t0_ns, self.t1_ns, names,
                           np.asarray(nid, np.int32), np.asarray(st, np.int64),
                           np.asarray(du, np.int64), np.asarray(ker, bool))
