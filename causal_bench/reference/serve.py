"""The plain reference of the streaming engines' column window and of
the live serving loop's admission, on a static overlay.

The windowed engine runs rounds in segments of ``seg_len`` and holds a
broadcast in one of ``window`` columns from the start of the segment
its round falls in until the end of the first segment by which every
process has delivered it — round ``r + ecc(o)`` — when it is retired.
:func:`batch_columns` gives the most columns ever held for a
pre-scripted schedule.

:func:`serve` is the serving loop of a live deployment with ``defer``
admission, tick by tick: submissions whose round has passed join a
bounded queue (tail-dropped when full); each tick admits up to the free
columns, at most ``per_round_cap`` a round and one per origin a round,
placing the queue's head round-robin over the segment's rounds (a
submission whose origin collides in every round keeps its place for
the next tick); the admitted broadcasts run the segment; the finished
ones retire at its end.  The loop stops once every submission is
admitted and every column retired, or at the round bound of the
deployment.  It imports nothing of the program.
"""

from __future__ import annotations

import heapq
import math
from collections import deque
from typing import Dict

import numpy as np

__all__ = ["batch_columns", "serving_bound", "serve"]

# full-delivery round of a broadcast that does not reach every process
_NEVER = 2 ** 62


def batch_columns(rnd: np.ndarray, done: np.ndarray, rounds: int,
                  seg_len: int) -> int:
    """Most columns held at once: broadcasts of round ``rnd`` activate at
    the start of their segment and retire at the end of the first
    segment whose last round is at least ``done`` (never where ``done``
    is negative: not every process is reached)."""
    rnd = np.asarray(rnd, np.int64)
    done = np.where(np.asarray(done) < 0, _NEVER, done).astype(np.int64)
    ends = np.minimum(np.arange(seg_len, rounds + seg_len, seg_len), rounds)
    # live during segment j: activated in segments <= j, retired after j
    act = np.searchsorted(ends, rnd, side="right")
    ret = np.searchsorted(ends - 1, done, side="left")
    delta = np.zeros(len(ends) + 1, np.int64)
    np.add.at(delta, act, 1)
    np.add.at(delta, np.minimum(ret + 1, len(ends)), -1)
    return int(np.cumsum(delta)[: len(ends)].max(initial=0))


def serving_bound(n: int, k: int, max_delay: int, pong_delay: int,
                  base_rounds: int, window: int, seg_len: int,
                  per_round_cap: int, messages: int,
                  last_arrival: int) -> int:
    """The round bound of a live deployment: the arrival span, the settle
    time of the overlay and a drain allowance for a window that admits
    at most ``window // 2 + 1`` broadcasts a segment."""
    diam = math.ceil(math.log(max(n, 2)) / math.log(max(k - 1, 2))) + 3
    settle = (diam + 2) * max_delay + 2 * pong_delay + 6
    per_seg = max(1, min(window // 2 + 1, per_round_cap * seg_len))
    drain = seg_len * (4 + 2 * int(np.ceil(messages / per_seg)))
    return int(max(base_rounds, last_arrival + 2 + settle + drain))


def serve(arr_round: np.ndarray, arr_origin: np.ndarray, ecc: np.ndarray,
          window: int, seg_len: int, per_round_cap: int, queue_cap: int,
          bound: int) -> Dict:
    """Admission outcome of serving the trace: the admitted schedule in
    admission order (``round``, ``origin``, ``submit``) and the loop's
    counts."""
    arr_round = np.asarray(arr_round, np.int64)
    arr_origin = np.asarray(arr_origin, np.int64)
    m = len(arr_round)
    queue: deque = deque()
    ptr = t = admitted = shed = queue_peak = backpressure = ticks = 0
    live = peak = 0
    retiring: list = []             # heap of full-delivery rounds
    out_r, out_o, out_s = [], [], []
    while t < bound and not (ptr >= m and not queue and live == 0):
        t_end = min(t + seg_len, bound)
        hi = int(np.searchsorted(arr_round, t))
        while ptr < hi:
            if len(queue) < queue_cap:
                queue.append((int(arr_round[ptr]), int(arr_origin[ptr])))
            else:
                shed += 1
            ptr += 1
        queue_peak = max(queue_peak, len(queue))
        nrounds = t_end - t
        if queue and nrounds > 0:
            want = len(queue)
            cap = min(nrounds * per_round_cap, max(0, window - live),
                      m - admitted)
            k = min(want, cap)
            counts = [0] * nrounds
            used = [set() for _ in range(nrounds)]
            batch, skipped = [], []
            while queue and len(batch) < k:
                sub, org = queue.popleft()
                start = len(batch) % nrounds
                for j in range(nrounds):
                    r = (start + j) % nrounds
                    if counts[r] < per_round_cap and org not in used[r]:
                        counts[r] += 1
                        used[r].add(org)
                        batch.append((t + r, sub, org))
                        break
                else:
                    skipped.append((sub, org))
            for item in reversed(skipped):
                queue.appendleft(item)
            if len(batch) < want:
                backpressure += 1
            batch.sort(key=lambda b: b[0])
            for r, sub, org in batch:
                out_r.append(r)
                out_s.append(sub)
                out_o.append(org)
                e = int(ecc[org])
                heapq.heappush(retiring, r + e if e >= 0 else _NEVER)
            admitted += len(batch)
            live += len(batch)
        peak = max(peak, live)
        while retiring and retiring[0] <= t_end - 1:
            heapq.heappop(retiring)
            live -= 1
        t = t_end
        ticks += 1
    return dict(round=np.asarray(out_r, np.int64),
                origin=np.asarray(out_o, np.int64),
                submit=np.asarray(out_s, np.int64),
                admitted=admitted, shed=shed,
                unserved=len(queue) + (m - ptr), rounds=t, ticks=ticks,
                queue_peak=queue_peak, backpressure_ticks=backpressure,
                peak_live=peak)
