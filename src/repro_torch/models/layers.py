"""Core transformer layers: RMSNorm, RoPE and M-RoPE, GQA attention
(causal / local / full / cross, with the blockwise branch), one-token
decode attention against a KV cache, the SwiGLU MLP.

The port of the JAX package's ``models/layers.py``.  Functions take a
parameter module (``p.wq`` where JAX reads ``p["wq"]``) and keep the JAX
layouts: activations (B, S, d), heads (B, S, H, D), caches (B, S, KV,
D).  Plain matrix products stay ``torch.matmul``: the JAX package leaves
them to XLA, outside any kernel.  Products that JAX accumulates in f32
(``preferred_element_type``) are taken here on f32 copies of their
operands, which for bf16 inputs is the same product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm", "rope", "mrope", "attention", "decode_attention",
    "decode_cross_attention", "mlp",
    "init_dense", "big_neg", "make_mask", "ATTN_CHUNK",
]


def big_neg(dtype) -> float:
    """The masked score: -0.7 times the type's largest value (not -inf)."""
    return -0.7 * float(torch.finfo(dtype).max)


def init_dense(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal with 1/sqrt(fan_in), drawn in f32 from ``gen``."""
    fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device) * scale
    return w.to(dtype)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with f32 statistics, cast back to the activation type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * g.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------- #
def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim/2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding on the two halves of the head (not interleaved
    pairs).  x (B, S, H, D), positions (B, S)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]    # (B,S,1,D/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope(x: torch.Tensor, positions: torch.Tensor, sections,
          theta: float = 1e4):
    """Multimodal RoPE (Qwen2-VL): positions (B, 3, S), one position
    stream a section group (temporal, height, width); the head_dim/2
    frequency axis is split by ``sections``, section i reading stream i."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = torch.cat([positions[:, i:i + 1].float().expand(-1, n, -1)
                     for i, n in enumerate(sections)], dim=1)  # (B,half,S)
    ang = pos.transpose(1, 2) * freqs                        # (B,S,half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rotate(cfg, q, k, positions):
    """RoPE on q and k: M-RoPE for (B, 3, S) positions of an M-RoPE arch,
    else RoPE on (B, S) positions (the first stream of (B, 3, S) ones)."""
    if cfg.mrope and positions.dim() == 3:
        return (mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
                mrope(k, positions, cfg.mrope_sections, cfg.rope_theta))
    pos2 = positions if positions.dim() == 2 else positions[:, 0]
    return rope(q, pos2, cfg.rope_theta), rope(k, pos2, cfg.rope_theta)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def make_mask(sq: int, skv: int, kind: str, window: int = 0,
              offset: int = 0, device=None):
    """(sq, skv) boolean mask; True = attend.  ``offset`` shifts the
    query positions."""
    if kind == "full":
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if kind == "local":
        m &= kj > qi - window
    return m


def _sdpa(q, k, v, mask, compute_dtype):
    """q (B,Sq,H,D), k/v (B,Skv,KV,D) GQA; scores and softmax in f32."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (dh ** -0.5)
    scores = torch.where(mask, scores, torch.tensor(
        big_neg(torch.float32), device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, dh)


# Query-chunk size of blockwise attention: scores exist only as
# (B, H, CHUNK, Skv) at a time, never as the whole (Sq, Skv) matrix.
ATTN_CHUNK = 512


def _sdpa_blockwise(q, k, v, mask_kind: str, window: int, compute_dtype,
                    chunk: int = ATTN_CHUNK):
    """Exact chunked attention: a loop over q chunks, each a full softmax
    over the keys it can see — keys < (i+1)*chunk and, for local
    attention, none older than the window's first chunk."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    groups = h // kv
    outs = []
    for i in range(sq // chunk):
        qg = q[:, i * chunk:(i + 1) * chunk].reshape(b, chunk, kv, groups, dh)
        hi = (i + 1) * chunk
        lo = 0
        if mask_kind == "local" and window:
            lo = max(0, ((i * chunk - window + 1) // chunk) * chunk)
        ks, vs = k[:, lo:hi], v[:, lo:hi]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), ks.float())
        scores = scores * (dh ** -0.5)
        qi = i * chunk + torch.arange(chunk, device=q.device)[:, None]
        kj = lo + torch.arange(hi - lo, device=q.device)[None, :]
        m = kj <= qi
        if mask_kind == "local":
            m &= kj > qi - window
        scores = torch.where(m, scores, torch.tensor(
            big_neg(torch.float32), device=scores.device))
        probs = torch.softmax(scores, dim=-1).to(compute_dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", probs, vs)
        outs.append(o.reshape(b, chunk, h, dh))
    return torch.cat(outs, dim=1)


def _project(p, cfg, x, src):
    """q from x, k and v from ``src`` (x itself, or the encoder output of
    cross attention), qk-normed where the arch says so."""
    cd = x.dtype
    b, s, _ = x.shape
    skv = src.shape[1]
    q = (x @ p.wq.to(cd)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (src @ p.wk.to(cd)).reshape(b, skv, cfg.num_kv_heads, cfg.head_dim)
    v = (src @ p.wv.to(cd)).reshape(b, skv, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor,
              mask_kind: str = "causal",
              xattn_kv: Optional[torch.Tensor] = None):
    """Self- or cross-attention over a full sequence (prefill / forward).
    positions (B, S), or (B, 3, S) for an M-RoPE arch.  With ``xattn_kv``
    (B, S_enc, d) k and v come from it, unrotated, under a full mask.
    Returns (out, (k, v)) with k, v for the cache.  The blockwise branch
    runs for causal or local self-attention over a multiple of
    ``ATTN_CHUNK`` above one chunk."""
    b, s, _ = x.shape
    cd = x.dtype
    src = x if xattn_kv is None else xattn_kv
    skv = src.shape[1]
    q, k, v = _project(p, cfg, x, src)
    if xattn_kv is None:
        q, k = _rotate(cfg, q, k, positions)
    else:
        mask_kind = "full"
    if (cfg.attn_impl == "blockwise" and mask_kind in ("causal", "local")
            and s % ATTN_CHUNK == 0 and s > ATTN_CHUNK):
        out = _sdpa_blockwise(q, k, v, mask_kind, cfg.window, cd)
    else:
        mask = make_mask(s, skv, mask_kind, cfg.window, device=x.device)
        out = _sdpa(q, k, v, mask, cd)
    out = out.reshape(b, s, cfg.attn_q_dim) @ p.wo.to(cd)
    return out, (k, v)


def decode_attention(p, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cur_index, window: int = 0):
    """One-token decode against a KV cache.

    x (B, 1, d); cache_k/v (B, S, KV, D).  ``cur_index`` is an int (every
    row at one position) or a (B,) integer tensor (continuous batching:
    each row at its own).  For windowed layers whose cache holds at most
    ``window`` slots the cache is a circular buffer: position t lives in
    slot t % S (RoPE is applied with absolute positions before the
    write, so slot order does not matter), as the prefill's roll leaves
    it.  The caches are updated in place (the JAX function returns new
    ones) and returned."""
    b = x.shape[0]
    cd = x.dtype
    smax = cache_k.shape[1]
    q, k, v = _project(p, cfg, x, x)
    if isinstance(cur_index, torch.Tensor) and cur_index.dim() == 1:
        pos = cur_index.to(device=x.device, dtype=torch.int32)[:, None]
    else:
        pos = torch.full((b, 1), int(cur_index), dtype=torch.int32,
                         device=x.device)
    # an M-RoPE arch decodes with its three streams equal
    q, k = _rotate(cfg, q, k, pos[:, None, :].expand(b, 3, 1)
                   if cfg.mrope else pos)

    circular = bool(window) and smax <= window
    wpos = (pos[:, 0] % smax if circular else pos[:, 0]).long()
    rows = torch.arange(b, device=x.device)
    cache_k[rows, wpos] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, wpos] = v[:, 0].to(cache_v.dtype)
    kj = torch.arange(smax, device=x.device)[None, :]   # (1, S)
    cur = pos[:, :1]                                     # (B, 1)
    if circular:
        # every written slot is within the window by construction
        valid = (kj <= cur) | (cur >= smax)
    else:
        valid = kj <= cur
        if window:
            valid &= kj > cur - window
    mask = valid[:, None, None, None, :]                 # (B,1,1,1,S)
    out = _sdpa(q, cache_k.to(cd), cache_v.to(cd), mask, cd)
    out = out.reshape(b, 1, cfg.attn_q_dim) @ p.wo.to(cd)
    return out, cache_k, cache_v


def decode_cross_attention(p, cfg, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor):
    """One-token cross attention against the encoder's cached k, v (B,
    S_enc, KV, D) under a full mask.  As in the JAX package's decode, q is
    neither qk-normed nor rotated."""
    b = x.shape[0]
    cd = x.dtype
    q = (x @ p.wq.to(cd)).reshape(b, 1, cfg.num_heads, cfg.head_dim)
    mask = torch.ones((1, 1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, k.to(cd), v.to(cd), mask, cd)
    return out.reshape(b, 1, cfg.attn_q_dim) @ p.wo.to(cd)


# --------------------------------------------------------------------- #
# MLP (SwiGLU)
# --------------------------------------------------------------------- #
def mlp(p, x: torch.Tensor):
    cd = x.dtype
    h = F.silu(x @ p.w_gate.to(cd)) * (x @ p.w_up.to(cd))
    return h @ p.w_down.to(cd)
