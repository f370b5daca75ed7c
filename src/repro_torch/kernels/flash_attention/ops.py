"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``),
with the contract of the JAX package's ``flash_attention`` op: q padded
to a multiple of ``block_q``, k and v to one of ``block_k``, the padded
keys masked by the true length and the padded query rows dropped.  The
kernel walks its own 64-row tiles, so the block sizes set the padding
only.  The backward recomputes through the plain version, as the JAX
op's ``custom_vjp`` does; no model calls the op.  On ``meta`` tensors
the launch and its backward only allocate (2 B H Sq Skv D flops for
each of the two products, causal or not, and twice that a backward);
a DTensor runs on its local shards, sharded over the batch at most."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import common
from .ref import flash_attention_ref

__all__ = ["flash_attention", "launch_flash_attention"]


def launch_flash_attention(q, k, v, o, causal: bool, seq_kv: int):
    """The bare launch: unchecked, uncounted, into ``o`` (q's shape)."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    common.raise_on("flash_attention", common.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kv,
        sq, skv, d, int(seq_kv), int(bool(causal)),
        common.DTYPE_CODE[q.dtype], float(d ** -0.5),
        common.stream(q.device)))


def _flops(q, k) -> int:
    b, h, sq, d = q.shape
    return 4 * b * h * sq * k.shape[2] * d


def _pad_to(x, mult: int):
    pad = (-x.shape[2]) % mult
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, H, S, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    dev = q.device
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    common.check("q", q, q.shape, dev)
    common.check("k", k, (b, kv, skv, d), dev, q.dtype)
    common.check("v", v, (b, kv, skv, d), dev, q.dtype)
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not share {kv} kv heads")
    if d > 256:
        raise ValueError(f"head_dim {d} > 256")
    return dev


def _forward(q, k, v, causal, block_q, block_k):
    dev = _check(q, k, v)
    sq, skv = q.shape[2], k.shape[2]
    qp, kp, vp = _pad_to(q, block_q), _pad_to(k, block_k), _pad_to(v, block_k)
    if not common.route(dev):
        return flash_attention_ref(qp, kp, vp, causal, seq_kv=skv)[:, :, :sq]
    if dev.type == "meta":
        return common.meta_out(q, list(q.shape), q.dtype, _flops(q, k))
    o = torch.empty_like(qp)
    launch_flash_attention(qp, kp, vp, o, causal, skv)
    common.LAUNCHES["flash_attention"] += 1
    return o[:, :, :sq]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if g.device.type == "meta":
            return (common.meta_out(q, list(q.shape), q.dtype,
                                    2 * _flops(q, k)),
                    common.meta_out(k, list(k.shape), k.dtype, 0),
                    common.meta_out(v, list(v.shape), v.dtype, 0),
                    None, None, None)
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_ref(*args, causal=ctx.causal)
            grads = torch.autograd.grad(out, args, g)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """q (B, H, Sq, D); k, v (B, KV, Skv, D), float32 or bfloat16, one
    type, D <= 256 -> (B, H, Sq, D) in q's type.  The kernel on CUDA
    tensors, the plain version on CPU tensors; differentiable."""
    if common.is_dtensor(q):
        bd = {0: 0}
        return common.local_call(
            lambda q_, k_, v_: flash_attention(
                q_.contiguous(), k_.contiguous(), v_.contiguous(), causal,
                block_q, block_k),
            (q, k, v), (bd, bd, bd), bd)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
