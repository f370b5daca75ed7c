"""Copies between host and card that block the host (the windowed
engine's ``copy.h2d`` and ``copy.d2h`` spans: set-up, every segment,
the upload of a segment's link additions and removals, the finish)
over the rounds the window simulated on the churn cell; nothing where
the repetitions hold no such span."""


def read(ctx):
    copies = sum(1 for rep in ctx.reps for (name, _, _) in rep.spans
                 if name.startswith("copy."))
    if not copies or not ctx.rounds:
        return None
    return copies / ctx.rounds
