"""Update compression for the cross-pod gossip plane.

The port of the JAX package's ``training/compression.py``: top-k
sparsification with error feedback (the residual of what was not sent
is carried into the next round, so the compressed gossip stays unbiased
over time).  A payload is int32 indices plus the kept values, ~(1 -
k/n) x 2 smaller than a dense f32 update.

Trees are dicts of tensors.  The selection is a stable ascending sort
of ``|x|`` keeping the last k, so its indices equal ``jnp.argsort``'s
(stable too) on equal inputs, ties included.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["topk_compress", "topk_decompress", "ErrorFeedback",
           "payload_bytes"]

Compressed = Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]


def topk_compress(tree: Dict[str, torch.Tensor], frac: float
                  ) -> Dict[str, Compressed]:
    """Keep the largest-|value| ``frac`` of entries of each leaf: a dict
    of (int32 indices, values, shape)."""
    def one(x):
        k = max(1, int(x.numel() * frac))
        flat = x.reshape(-1)
        idx = torch.argsort(flat.abs(), stable=True)[-k:]
        return idx.to(torch.int32), flat[idx], tuple(x.shape)
    return {name: one(x) for name, x in tree.items()}


def topk_decompress(ctree: Dict[str, Compressed]) -> Dict[str, torch.Tensor]:
    def one(idx, vals, shape):
        n = 1
        for d in shape:
            n *= d
        out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
        out[idx.long()] = vals
        return out.reshape(shape)
    return {name: one(*t) for name, t in ctree.items()}


def payload_bytes(ctree: Dict[str, Compressed]) -> int:
    return sum(idx.numel() * 4 + vals.numel() * vals.element_size()
               for idx, vals, _ in ctree.values())


class ErrorFeedback:
    """Residual memory: compress(update + residual); the residual carries
    the untransmitted remainder."""

    def __init__(self, frac: float):
        self.frac = frac
        self.residual = None

    def compress(self, tree: Dict[str, torch.Tensor]):
        if self.residual is not None:
            tree = {k: x + self.residual[k] for k, x in tree.items()}
        ctree = topk_compress(tree, self.frac)
        sent = topk_decompress(ctree)
        self.residual = {k: x - sent[k] for k, x in tree.items()}
        return ctree
