"""What the metric readers (``causal_bench/metrics/<name>.py``) read: the
context of a finished run, and the few computations they share.

Every reader returns a number, or None where the run has nothing for
it to read; the harness then leaves the metric out of the line.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Context", "span_mean_ms", "per_tick_ms", "roofline_share",
           "idle_share", "launches_per_round", "rate"]


@dataclass
class Context:
    setup_s: float
    wall_s: float                   # the measured window, host clock
    reps: list                      # drivers._judge.Rep, in order
    # the repetitions of a window with tracing off: ``reps`` themselves
    # in a ``--trace 0`` run, those of the untraced window that a
    # ``--trace 1`` run makes first for a reader marked ``UNTRACED``
    untraced: list = field(default_factory=list)
    trace: Optional[object] = None  # harness.trace.DeviceTrace
    # kernel -> (launches, summed bound seconds) of one counted repetition
    rooflines: Dict[str, Tuple[int, float]] = field(default_factory=dict)

    def work(self, unit: str) -> Optional[int]:
        if not self.reps or unit not in self.reps[0].work:
            return None
        return sum(r.work[unit] for r in self.reps)

    @property
    def rounds(self) -> int:
        return sum(r.rounds for r in self.reps)

    def span_ns(self, name: str) -> np.ndarray:
        return np.asarray([t1 - t0 for r in self.reps
                           for (n, t0, t1) in r.spans if n == name],
                          np.int64)

    def tick_ns(self, untraced: bool = False) -> np.ndarray:
        """Wall nanoseconds of every serving tick, of ``reps`` or, with
        ``untraced``, of the untraced window."""
        parts: List[np.ndarray] = [
            r.tick_ns for r in (self.untraced if untraced else self.reps)]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def rate(ctx: Context, unit: str) -> Optional[float]:
    """Work of ``unit`` completed in the window over its wall seconds."""
    done = ctx.work(unit)
    if done is None or ctx.wall_s <= 0:
        return None
    return done / ctx.wall_s


def span_mean_ms(ctx: Context, name: str) -> Optional[float]:
    d = ctx.span_ns(name)
    return float(d.mean()) / 1e6 if len(d) else None


def per_tick_ms(ctx: Context, names) -> Optional[float]:
    """Summed duration of the spans ``names`` a serving tick."""
    ticks = len(ctx.span_ns("tick"))
    if not ticks:
        return None
    return float(sum(ctx.span_ns(n).sum() for n in names)) / ticks / 1e6


def launches_per_round(ctx: Context) -> Optional[float]:
    """Every kernel the device trace holds, over the rounds simulated."""
    if ctx.trace is None or not ctx.rounds:
        return None
    return ctx.trace.kernels() / ctx.rounds


def idle_share(ctx: Context) -> Optional[float]:
    """Percent of the traced window in which nothing ran on the card."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def roofline_share(ctx: Context, kernel: str, module) -> Optional[float]:
    """Percent of the roofline: the bound of the window's launches (each
    repetition's launches are the counted one's) over their kernel time
    in the device trace."""
    counted = ctx.rooflines.get(kernel)
    if ctx.trace is None or not counted or not counted[0]:
        return None
    launches, _ = ctx.trace.kernel_ns(module.LAUNCH_KERNEL)
    _, busy_ns = ctx.trace.kernel_ns(module.KERNELS)
    if not launches or not busy_ns:
        return None
    bound_s = counted[1] / counted[0] * launches
    return 100.0 * bound_s / (busy_ns / 1e9)
