"""Admission policies for the live serving front door — the port's copy
of the JAX package's ``repro.core.vecsim.live.admission``.

Each tick the serving loop plans which queued submissions enter the
next segment's traffic plane.  The policy decides how the plan relates
to the engine's *capacity signal* — free live columns minus the
pre-scripted activations (link pings) due in the segment, i.e. exactly
the occupancy :class:`~repro_torch.core.vecsim.stream.ColumnWindow` tracks:

* ``defer`` (capacity-aware, keep) — admit up to capacity; the excess
  waits in the queue and its queueing delay lands in the latency
  percentiles.  The default: lossless backpressure.
* ``shed``  (capacity-aware, drop) — admit up to capacity, drop the
  rest; queueing delay stays near zero at the cost of a shed rate.
* ``admit`` (capacity-blind)       — admit everything up to the
  per-round schedule cap regardless of window occupancy.  Overfills on
  purpose: it exercises the ``WindowOverflowError`` catch-and-defer
  path (the raise is state-clean, the loop withdraws the unactivated
  admissions, requeues them and retries the segment).

All three respect ``per_round_cap`` and per-(origin, round)
uniqueness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = ["AdmissionPolicy", "_ADMISSION"]


@dataclass(frozen=True)
class AdmissionPolicy:
    """A named admission behavior: whether the tick plan is clamped to
    the window's free-column capacity, and whether the un-admitted
    excess is dropped (shed) or kept queued (deferred)."""

    name: str
    description: str
    capacity_aware: bool
    drop_excess: bool


_ADMISSION: Dict[str, AdmissionPolicy] = {
    "defer": AdmissionPolicy(
        "defer",
        "clamp admissions to free window capacity; excess waits in the "
        "queue (lossless backpressure, queueing delay in latency)",
        capacity_aware=True, drop_excess=False),
    "shed": AdmissionPolicy(
        "shed",
        "clamp admissions to free window capacity; excess is dropped "
        "(bounded latency at the cost of a shed rate)",
        capacity_aware=True, drop_excess=True),
    "admit": AdmissionPolicy(
        "admit",
        "admit up to the per-round cap regardless of occupancy; relies "
        "on the state-clean WindowOverflowError catch-and-defer path",
        capacity_aware=False, drop_excess=False),
}
