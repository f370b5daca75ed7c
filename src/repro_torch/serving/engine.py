"""Batched serving engine: prefill + decode with slot-based continuous
batching.

The port of the JAX package's ``serving/engine.py``.  A fixed pool of
``batch`` slots decodes in lock-step, one ``decode_step`` a tick, each
slot at its own position (a per-row ``cur_index``).  A request is
admitted into a free slot by prefilling its prompt and copying its
caches into the slot's row; it retires at ``max_new_tokens``, at EOS, or
when its slot reaches ``max_len - 1``.  The caches live on the model's
device and are sized, at the first admission, from that prefill's.

Greedy decoding (temperature 0) is the parity path: its tokens equal
the JAX engine's whenever the logits agree.  Temperature sampling draws
from a ``torch.Generator`` seeded with ``ServeConfig.seed``; it cannot
reproduce ``jax.random.categorical``'s draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Request", "ServeConfig", "ServingEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0      # 0 = greedy
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeConfig:
    batch: int = 4                # decode slots
    max_len: int = 256            # cache length
    eos_id: int = -1              # -1: never stops early
    seed: int = 0


def _map(fn, *trees):
    """``fn`` over the leaves (tensors) of caches nested in lists,
    tuples and dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


class ServingEngine:
    def __init__(self, model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * cfg.batch
        self.pos = np.zeros(cfg.batch, np.int32)      # next write index
        self.caches = None
        self.gen = torch.Generator(device=model.device).manual_seed(cfg.seed)
        self.ticks = 0
        self.finished: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ---------------- internals --------------------------------------- #
    def _admit(self) -> None:
        """Fill free slots: prefill the prompt, copy its caches in."""
        for i in range(self.cfg.batch):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.from_numpy(np.asarray(req.prompt, np.int64)[None])
            last, caches = self.model.prefill(prompt.to(self.model.device),
                                              pad_to=self.cfg.max_len)
            req.out_tokens.append(int(self._sample(last, req)[0]))
            if self.caches is None:
                self.caches = _map(lambda c: c.new_zeros(
                    (self.cfg.batch,) + tuple(c.shape[1:])), caches)

            def put(full, one, i=i):
                full[i:i + 1] = one.to(full.dtype)
                return full
            self.caches = _map(put, self.caches, caches)
            self.slots[i] = req
            self.pos[i] = len(req.prompt)

    def _sample(self, logits: torch.Tensor, req: Request) -> np.ndarray:
        if req.temperature <= 0.0:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / req.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0] \
            .cpu().numpy()

    def _retire(self, i: int) -> None:
        self.slots[i] = None
        self.pos[i] = 0

    # ---------------- main loop ---------------------------------------- #
    def step(self) -> int:
        """One engine tick: admit, then one decode step for all active
        slots.  Returns the number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        tokens = np.zeros(self.cfg.batch, np.int64)
        for i in active:
            tokens[i] = self.slots[i].out_tokens[-1]
        dev = self.model.device
        logits, self.caches = self.model.decode_step(
            torch.from_numpy(tokens).to(dev), self.caches,
            torch.from_numpy(self.pos.copy()).to(dev))
        self.ticks += 1
        greedy = logits.argmax(dim=-1).cpu().numpy()   # one wait a tick
        for i in active:
            req = self.slots[i]
            nxt = int(greedy[i] if req.temperature <= 0.0
                      else self._sample(logits[i:i + 1], req)[0])
            req.out_tokens.append(nxt)
            self.pos[i] += 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or nxt == self.cfg.eos_id
                    or self.pos[i] >= self.cfg.max_len - 1):
                req.done = True
                self.finished.append(req)
                self._retire(i)
        return len(active)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until the queue and the slots are empty (or ``max_ticks``);
        returns the requests finished in this call, in the order they
        finished.  (The JAX engine's ``run`` returns an empty list: its
        ``_retire`` empties a slot before the check that would collect
        it.)"""
        start = len(self.finished)
        while (self.queue or any(self.slots)) and self.ticks < max_ticks:
            self.step()
        return self.finished[start:]
