"""Plain PyTorch version of the flash-attention kernel: one softmax over
all keys with the kernel's mask and arithmetic.

The mask is the kernel's: keys at or past ``seq_kv`` are padding and,
when causal, key j is seen by query i only if j <= i — aligned at the
*start* of both sequences.  (The JAX package's ``attention_ref`` aligns
the ends instead; the two agree when Sq == Skv.)  A row left with no key
gives 0, as in the kernel."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref"]

NEG_INF = -1e30


def flash_attention_ref(q, k, v, causal: bool = True,
                        seq_kv: Optional[int] = None):
    """q (B, H, Sq, D); k, v (B, KV, Skv, D) -> (B, H, Sq, D) in q's type,
    GQA (query head h reads kv head h // (H / KV)), float32 inside."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    seq_kv = skv if seq_kv is None else seq_kv
    qf = q.float().reshape(b, kv, h // kv, sq, d) * (d ** -0.5)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = kj < seq_kv
    if causal:
        mask = mask & (kj <= torch.arange(sq, device=q.device)[:, None])
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, sq, d).to(q.dtype)
