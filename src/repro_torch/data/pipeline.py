"""Deterministic synthetic token pipeline — the port's own copy of the
JAX package's ``data/pipeline.py`` (pure numpy), whose batches it equals
byte for byte.  Batches stay numpy here, in the prefetch thread too; the
training loop moves them to the device.

Generates language-like token streams from a seeded Markov-ish process
entirely on the host, with: deterministic resume (state = (seed, step)),
per-data-shard slicing (each data-parallel rank reads only its rows), and
double-buffered prefetch.  Loss on this data genuinely decreases under
training (local bigram structure), which the gossip-convergence tests and
examples rely on.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "prefetch"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0          # this host's data shard
    num_shards: int = 1
    n_modes: int = 32       # latent bigram modes (structure to learn)


class SyntheticLM:
    """Stateless-resumable synthetic LM batches.

    Each sequence follows one of ``n_modes`` latent cyclic bigram chains
    plus noise — enough structure that even small models show steadily
    decreasing loss, while batch generation stays O(B*S) numpy."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.num_shards == 0
        self.local_batch = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # mode m walks tokens in arithmetic progression step_m (mod v)
        self.mode_step = rng.integers(1, v - 1, size=cfg.n_modes)
        self.mode_start = rng.integers(0, v, size=cfg.n_modes)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for global ``step`` — pure function of (seed, step, shard)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + cfg.shard)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        modes = rng.integers(0, cfg.n_modes, size=(b, 1))
        start = self.mode_start[modes] + rng.integers(0, v, size=(b, 1))
        ar = start + self.mode_step[modes] * np.arange(s + 1)[None, :]
        toks = ar % v
        noise = rng.random((b, s + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, v, size=(b, s + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (double buffering)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for x in it:
                q.put(x)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is stop:
            return
        yield x
