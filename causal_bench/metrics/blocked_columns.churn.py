"""Mean of the windowed engine's ``segment.blocked`` counter over the
window's segments: live app columns that every process has delivered
and only a pending gate keeps (a gate opened at or before a delivery
of the column and not yet flushed), at each segment's retirement — the
window that gating costs.  Nothing where the repetitions hold no such
counter, as the program before the counter had none."""

import numpy as np

COUNTER = "segment.blocked"


def read(ctx):
    vals = [v for rep in ctx.reps
            for (name, v) in rep.out.get("counters", ()) if name == COUNTER]
    return float(np.mean(vals)) if vals else None
