"""95th percentile (nearest rank) of the wall time of every serving tick
of the window with tracing off, from the loop's ``on_tick`` stamps on
the host clock.  Read from the untraced window (``UNTRACED``): a
``--trace 1`` run makes one before its traced window, so that neither
the profiler's nor the spans' cost a launch is in the tick."""

import math

import numpy as np

UNTRACED = True


def read(ctx):
    ticks = np.sort(ctx.tick_ns(untraced=True))
    if not len(ticks):
        return None
    return float(ticks[math.ceil(0.95 * len(ticks)) - 1]) / 1e6
