"""The benchmark's one general input generator.

A configuration file states the deployment (processes, out-slots,
delays, ``overlay``: the overlay's kind); a traffic file states the mix
(``arrivals``: the arrival process, its parameters, ``messages`` a
repetition).  Both kinds are files of their own, found by name:

* ``gen/overlays/<overlay>.py``, whose ``build(cfg, seed)`` returns the
  overlay ``(adj0, delay0)``;
* ``gen/arrivals/<arrivals>.py``, whose ``inputs(cfg, mix, seed,
  adj0)`` returns the traffic: a schedule or a submission trace and the
  scenario's ``rounds`` (``gen/draw.py``).

So a new overlay or arrival process is a file added, and a new mix of a
known process a traffic file added.  Nothing here imports the program:
the harness wraps these arrays in the program's scenario type, and the
reference reads them as they are.
"""

from __future__ import annotations

from typing import Dict

from causal_bench.harness.spec import load_file

__all__ = ["build_inputs"]


def build_inputs(cfg: dict, mix: dict, seed: int) -> Dict:
    """The cell's inputs: ``n``, ``k``, ``adj0``, ``delay0``, ``rounds``,
    ``bcast_round``/``bcast_origin`` and, for a submission mix,
    ``arr_round``/``arr_origin``."""
    adj0, delay0 = load_file("gen/overlays", cfg["overlay"]).build(
        cfg, int(seed))
    rest = load_file("gen/arrivals", mix["arrivals"]).inputs(
        cfg, mix, int(seed), adj0)
    return dict(n=int(cfg["n"]), k=int(cfg["k"]), adj0=adj0, delay0=delay0,
                **rest)
