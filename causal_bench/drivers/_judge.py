"""The comparison that decides ``correct``, shared by the drivers of
the causal-broadcast cells: what a repetition produced against what
the plain reference works out from the same inputs.  Every number is
an exact integer comparison, so every limit is 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

__all__ = ["Rep", "Verdict", "outcome_wrong"]


@dataclass
class Rep:
    """One repetition of a cell's timed path."""

    t0_ns: int                      # monotonic clock, start and end
    t1_ns: int
    work: Dict[str, int]            # work completed, by unit
    offered: int                    # requests or broadcasts attempted
    rounds: int                     # simulated rounds
    out: Dict                       # what the reference judges
    spans: List[tuple] = field(default_factory=list)   # (name, t0, t1) ns
    tick_ns: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Verdict:
    checks: Dict[str, tuple]        # name -> (value, limit)
    attempted: int
    failed: int

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def _differ(a, b) -> np.ndarray:
    """Per entry: the two arrays disagree (every entry, if the lengths
    differ)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return np.ones(max(a.size, b.size), bool)
    return (a != b).reshape(-1)


def outcome_wrong(out: Dict, exp: Dict) -> Dict[str, np.ndarray]:
    """Per broadcast, whether its answers (deliveries, the sum of their
    rounds, the origin's own delivery) differ from the reference; and
    the counts of differing stats and histogram buckets."""
    per_msg = (_differ(out["deliv_count"], exp["deliv_count"])
               | _differ(out["deliv_round_sum"], exp["deliv_round_sum"])
               | _differ(out["bcast_done"], exp["bcast_done"]))
    stats = sum(int(out["stats"][key] != val)
                for key, val in exp["stats"].items())
    stats += int(_differ(out["series"], exp["series"]).sum())
    stats += int(out["lat_sum"] != exp["lat_sum"])
    stats += int(out["lat_cnt"] != exp["lat_cnt"])
    hist = int(_differ(out["latency_hist"], exp["latency_hist"]).sum())
    return dict(per_msg=per_msg, stats=stats, hist=hist)
