"""The ``kregular`` overlay: a frozen copy of the k-regular digraph
builder of ``repro_torch.core.vecsim.scenario`` (``kregular_topology``
and ``_perm_avoiding``).

Copied, not imported, so that a change to the program can never change
the inputs it is measured on: the same seed gives the same arrays here
as in the program's builder on the day it was copied
(``tests/test_cbench_gen.py`` holds them together while both exist).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["build", "kregular_topology"]


def _perm_avoiding(rng, n: int, forbidden: np.ndarray) -> np.ndarray:
    """Random permutation of ``range(n)`` with ``perm[p] != p`` and
    ``perm[p]`` not in ``forbidden[p]`` (an ``(n, j)`` column stack of
    already-used targets); conflicts are repaired by reshuffling the
    conflicted positions among themselves."""
    perm = rng.permutation(n).astype(np.int64)
    me = np.arange(n)
    for it in range(1000):
        bad = perm == me
        for c in range(forbidden.shape[1]):
            bad |= perm == forbidden[:, c]
        idx = np.nonzero(bad)[0]
        if not len(idx):
            return perm
        if len(idx) == 1 or it % 7 == 6:
            others = rng.integers(0, n, size=len(idx))
            for i, j in zip(idx, others):
                perm[i], perm[j] = perm[j], perm[i]
        else:
            perm[idx] = perm[idx[rng.permutation(len(idx))]]
    raise RuntimeError("could not build a conflict-free permutation "
                       f"(n={n}, {forbidden.shape[1]} forbidden/row)")


def kregular_topology(seed: int, n: int, k: int, max_delay: int = 3,
                      free_slots: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Random k-regular digraph: slot 0 is the directed ring and each
    further populated slot an independent random permutation; the last
    ``free_slots`` slots stay empty (-1).  Returns ``(adj0, delay0)``,
    int32 ``(n, k)``, delays drawn from ``[1, max_delay]``."""
    if n < k + 2:
        raise ValueError("need n >= k + 2 distinct targets per process")
    rng = np.random.default_rng(seed)
    adj0 = np.full((n, k), -1, np.int64)
    adj0[:, 0] = (np.arange(n) + 1) % n
    n_extra = max(0, k - 1 - free_slots)
    for j in range(1, n_extra + 1):
        adj0[:, j] = _perm_avoiding(rng, n, adj0[:, :j])
    delay0 = rng.integers(1, max_delay + 1, size=(n, k)).astype(np.int32)
    return adj0.astype(np.int32), delay0


def build(cfg: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's overlay from ``seed``: ``n``, ``k``,
    ``max_delay`` and ``free_slots``."""
    return kregular_topology(seed, cfg["n"], cfg["k"], cfg["max_delay"],
                             cfg["free_slots"])
