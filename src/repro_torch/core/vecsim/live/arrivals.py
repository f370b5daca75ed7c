"""Open-loop arrival processes for the live serving front door — the
port's copy of the JAX package's ``repro.core.vecsim.live.arrivals``.

Each process generates a pre-drawn submission trace — one ``(round,
origin)`` per offered message, round-sorted — that the serving loop
feeds into its bounded ingest queue as simulated time passes.  The load
is *open-loop*: clients submit on their own clock regardless of how the
system keeps up, which is what makes queueing delay and shed rate real
observables instead of artifacts of a closed feedback loop.

Origins are drawn uniformly (with replacement — independent clients);
the admission planner enforces the engine's per-(origin, round)
uniqueness when it schedules submissions into rounds.

Registered processes (``repro_torch.api`` exposes these as the
``arrivals`` registry):

* ``poisson`` — constant-rate Poisson arrivals, the steady-state
  capacity workload.
* ``bursty``  — low-rate Poisson baseline with periodic spike windows
  at the full rate (one spike when the period exceeds the span): the
  backpressure workload.
* ``diurnal`` — sinusoidal day-curve ramp (peak 2x the mean rate): the
  slow load-swing workload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np

__all__ = ["ArrivalProcess", "build_arrivals", "_ARRIVALS"]


@dataclass(frozen=True)
class ArrivalProcess:
    """A named open-loop arrival generator.

    ``build(rng, n, rate, messages, params)`` returns ``(rounds,
    origins)`` — ``messages`` submissions, round-sorted int32 — where
    ``rate`` is the *mean* offered submissions per round and ``params``
    carries the process knobs (``rate_lo``, ``period``, ``duty``)."""

    name: str
    description: str
    build: Callable[..., Tuple[np.ndarray, np.ndarray]]


def _from_lambda(rng: np.random.Generator, n: int, messages: int,
                 lam_fn) -> Tuple[np.ndarray, np.ndarray]:
    """Draw Poisson per-round counts under the intensity ``lam_fn(t)``
    until ``messages`` submissions exist, then trim."""
    chunks = []
    t0, total = 0, 0
    while total < messages:
        span = 1024
        lam = np.maximum(0.0, np.asarray(
            lam_fn(np.arange(t0, t0 + span)), float))
        if total == 0 and t0 > (1 << 22):
            raise ValueError("arrival intensity never produced traffic")
        cnt = rng.poisson(lam)
        chunks.append(cnt)
        total += int(cnt.sum())
        t0 += span
    counts = np.concatenate(chunks)
    rounds = np.repeat(np.arange(len(counts)),
                       counts)[:messages].astype(np.int32)
    origins = rng.integers(0, n, messages).astype(np.int32)
    return rounds, origins


def _poisson(rng, n, rate, messages, params):
    """Constant-rate Poisson: ``rate`` mean submissions per round."""
    return _from_lambda(rng, n, messages, lambda t: np.full(len(t), rate))


def _bursty(rng, n, rate, messages, params):
    """Poisson baseline at ``rate_lo`` with spike windows at ``rate``:
    the first ``duty`` fraction of every ``period`` rounds burns at the
    full rate.  With ``period`` at or beyond the run span this is
    "Poisson plus one spike"."""
    period = max(1, int(params.get("period", 256)))
    duty = float(params.get("duty", 0.25))
    rate_lo = params.get("rate_lo")
    if rate_lo is None:
        rate_lo = rate / 8.0
    on = max(1, int(round(duty * period)))
    return _from_lambda(
        rng, n, messages,
        lambda t: np.where((t % period) < on, rate, rate_lo))


def _diurnal(rng, n, rate, messages, params):
    """Sinusoidal day curve: intensity ``rate * (1 - cos(2*pi*t /
    period))`` — mean ``rate``, peak ``2*rate``, troughs near zero."""
    period = max(2, int(params.get("period", 256)))
    return _from_lambda(
        rng, n, messages,
        lambda t: rate * (1.0 - np.cos(2.0 * np.pi * t / period)))


_ARRIVALS: Dict[str, ArrivalProcess] = {
    "poisson": ArrivalProcess(
        "poisson",
        "constant-rate Poisson submissions (steady-state capacity load)",
        _poisson),
    "bursty": ArrivalProcess(
        "bursty",
        "low-rate Poisson with periodic full-rate spike windows "
        "(backpressure load; one spike when period >= span)",
        _bursty),
    "diurnal": ArrivalProcess(
        "diurnal",
        "sinusoidal day-curve ramp, mean rate with 2x peaks "
        "(slow load-swing load)",
        _diurnal),
}


def build_arrivals(kind: str, seed: int, n: int, rate: float,
                   messages: int, **params) -> Tuple[np.ndarray, np.ndarray]:
    """Generate the submission trace for a registered process."""
    try:
        proc = _ARRIVALS[kind]
    except KeyError:
        raise KeyError(
            f"unknown arrival process {kind!r}; known: "
            f"{sorted(_ARRIVALS)}") from None
    if messages < 1:
        raise ValueError("messages must be >= 1")
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    return proc.build(rng, n, float(rate), int(messages), params)
