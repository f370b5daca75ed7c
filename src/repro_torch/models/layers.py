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


def _ways(x: torch.Tensor, dim: int):
    """(mesh dims sharding ``dim`` of DTensor ``x``, the shards they make)."""
    from torch.distributed.tensor import Shard
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    ways = 1
    for i in on:
        ways *= x.device_mesh.size(i)
    return on, ways


def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` with dimension ``dim`` split into ``sizes`` (a head split).
    A DTensor sharded on ``dim`` whose shards would not split evenly
    (fewer heads than the mesh axis, as in JAX's divisibility rule) is
    first gathered along that dimension."""
    from ..kernels.common import is_dtensor
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        on, ways = _ways(x, dim)
        if on and sizes[0] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in on else p
                for i, p in enumerate(x.placements)])
    shape = tuple(x.shape)
    return x.reshape(shape[:dim] + tuple(sizes) + shape[dim + 1:])


class _MergeDims(torch.autograd.Function):
    """A reshape merging dims ``[dim, dim + len(sizes))``, whose backward
    splits the gradient with :func:`split_dim` (a DTensor gradient
    sharded unevenly for the split is gathered first)."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        shape = tuple(x.shape)
        return x.reshape(shape[:dim] + (-1,) + shape[dim + len(sizes):])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def merge_dims(x: torch.Tensor, dim: int, count: int) -> torch.Tensor:
    """``x`` with dims ``[dim, dim + count)`` merged into one (the heads
    back into a width); the inverse of :func:`split_dim`, also in the
    backward of a DTensor."""
    from ..kernels.common import is_dtensor
    shape = tuple(x.shape)
    if is_dtensor(x):
        return _MergeDims.apply(x, dim, shape[dim:dim + count])
    return x.reshape(shape[:dim] + (-1,) + shape[dim + count:])


def vocab_offset(mesh, on, vocab: int):
    """(this rank's first row, rows a shard) of a dimension of ``vocab``
    rows split over mesh dims ``on`` in mesh-dim order."""
    start, v_loc = 0, vocab
    for i in on:
        v_loc //= mesh.size(i)
    for i in on:
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    return start * v_loc, v_loc


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table sharded over its rows (the
    vocabulary) is looked up shard by shard: each shard fills the tokens
    it holds and zeros elsewhere, a partial sum over the vocabulary's
    mesh dims that the caller reduces in the layout it wants (Megatron's
    vocab-parallel embedding); the table is never gathered whole."""
    from ..kernels.common import is_dtensor
    if not (is_dtensor(table) and is_dtensor(tokens)
            and any(p.is_shard(0) for p in table.placements)):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    on = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    start, _ = vocab_offset(mesh, on, table.shape[0])
    tok_pl = [Replicate() if i in on else p
              for i, p in enumerate(tokens.placements)]
    tab_pl = [p if i in on else Replicate()
              for i, p in enumerate(table.placements)]

    def local(tab, tok):
        idx = tok - start
        mine = (idx >= 0) & (idx < tab.shape[0])
        rows = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab)
        return rows * mine[..., None].to(rows.dtype)

    # a shard of the table gets its gradient from the rows of the tokens
    # it saw: a partial sum over the mesh dims the tokens are split on
    tab_grad = [Partial() if i not in on and p.is_shard() else q
                for i, (p, q) in enumerate(zip(tok_pl, tab_pl))]
    return local_map(local, out_placements=[
        Partial() if i in on else p for i, p in enumerate(tok_pl)],
        in_placements=(tab_pl, tok_pl), in_grad_placements=(tab_grad, tok_pl),
        redistribute_inputs=True, device_mesh=mesh)(table, tokens)


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


def _grouped(q, k, v):
    """q as (B, Sq, KV, G, D) query groups of k, v's KV heads.  For a
    DTensor q whose heads are sharded more ways than KV divides (e.g. 8
    KV heads on a 16-way "model" axis) the groups would split unevenly:
    k and v are repeated to every query head instead (G = 1), the same
    products with the heads still sharded."""
    from ..kernels.common import is_dtensor
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    if is_dtensor(q) and kv < h and kv % _ways(q, 2)[1]:
        g = h // kv

        def rep(t):
            bt, st = t.shape[0], t.shape[1]
            return t[:, :, :, None].expand(bt, st, kv, g, dh).reshape(
                bt, st, h, dh)
        k, v, kv = rep(k), rep(v), h
    return split_dim(q, 2, (kv, h // kv)), k, v


def _sdpa(q, k, v, mask, compute_dtype):
    """q (B,Sq,H,D), k/v (B,Skv,KV,D) GQA; scores and softmax in f32."""
    b, sq, h, dh = q.shape
    qg, k, v = _grouped(q, k, v)
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
    attention, none older than the window's first chunk.  Plain tensors
    only (a DTensor attends on its local shards, :func:`attention`)."""
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


def _mesh_split(mesh):
    """(names of the mesh dims, the batch's mesh dims, the "model" dims,
    the ranks over "model"); a dim of one rank splits nothing and is in
    neither list."""
    names = mesh.mesh_dim_names
    dp = [i for i, n in enumerate(names)
          if n in ("pod", "data") and mesh.size(i) > 1]
    model = [i for i, n in enumerate(names)
             if n == "model" and mesh.size(i) > 1]
    ways = 1
    for i in model:
        ways *= mesh.size(i)
    return names, dp, model, ways


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` -> (B, Sq, H, D) on each rank's batch rows and
    query heads of DTensors q (B, Sq, H, D) and k, v (B, Skv, KV, D):
    attention is independent over both, so it runs on plain local
    tensors (``local_map``) and no DTensor op of its own has to plan a
    layout.  The batch splits over ("pod", "data") where it divides;
    the query heads over "model" where H divides, the KV heads with them
    where KV divides too, else each rank takes the KV heads its query
    heads read from the whole k and v (whose gradients are then partial
    sums over "model")."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names, dp, model, ways = _mesh_split(mesh)
    h, kv = q.shape[2], k.shape[2]
    rows = 1
    for i in dp:
        rows *= mesh.size(i)
    by_rows = q.shape[0] % rows == 0
    heads = ways > 1 and h % ways == 0 and len(model) == 1
    whole_kv = heads and kv % ways != 0

    def pl(split):
        return [Shard(0) if i in dp and by_rows else
                Shard(2) if i in model and split else Replicate()
                for i in range(len(names))]

    q_pl, kv_pl = pl(heads), pl(heads and not whole_kv)
    kv_grad = [Partial() if i in model and whole_kv else p
               for i, p in enumerate(kv_pl)]
    first = mesh.get_local_rank(model[0]) * (h // ways) if whole_kv else 0

    from ..kernels.common import dense_grad

    def local(ql, kl, vl):
        # a shard of the heads is a strided view; the products' backward
        # needs dense operands, and DTensor's views dense gradients
        ql, kl, vl = (dense_grad(t.contiguous()) for t in (ql, kl, vl))
        if whole_kv:
            idx = (first + torch.arange(ql.shape[2], device=kl.device)) \
                // (h // kv)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     redistribute_inputs=True, device_mesh=mesh)(q, k, v)


def _project(p, cfg, x, src):
    """q from x, k and v from ``src`` (x itself, or the encoder output of
    cross attention), qk-normed where the arch says so."""
    cd = x.dtype
    heads, kv = (cfg.num_heads, cfg.head_dim), (cfg.num_kv_heads,
                                                cfg.head_dim)
    q = split_dim(x @ p.wq.to(cd), 2, heads)
    k = split_dim(src @ p.wk.to(cd), 2, kv)
    v = split_dim(src @ p.wv.to(cd), 2, kv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor,
              mask_kind: str = "causal",
              xattn_kv: Optional[torch.Tensor] = None,
              seq_shard: bool = False):
    """Self- or cross-attention over a full sequence (prefill / forward).
    positions (B, S), or (B, 3, S) for an M-RoPE arch.  With ``xattn_kv``
    (B, S_enc, d) k and v come from it, unrotated, under a full mask.
    Returns (out, (k, v)) with k, v for the cache.  The blockwise branch
    runs for causal or local self-attention over a multiple of
    ``ATTN_CHUNK`` above one chunk; under a sequence-sharded residual
    (``seq_shard``) it re-gathers q, k and v once before the loop, at
    the JAX layer's constrain site (a no-op without an ambient mesh).
    DTensor q, k, v attend on their local rows and heads
    (:func:`_on_local_heads`)."""
    from ..kernels.common import is_dtensor
    s = x.shape[1]
    cd = x.dtype
    src = x if xattn_kv is None else xattn_kv
    skv = src.shape[1]
    q, k, v = _project(p, cfg, x, src)
    if xattn_kv is None:
        q, k = _rotate(cfg, q, k, positions)
    else:
        mask_kind = "full"
    blockwise = (cfg.attn_impl == "blockwise"
                 and mask_kind in ("causal", "local")
                 and s % ATTN_CHUNK == 0 and s > ATTN_CHUNK)
    if blockwise and seq_shard:
        from ..sharding.policy import constrain
        dp = ("pod", "data")
        q = constrain(q, dp, None, None, None)
        k = constrain(k, dp, None, None, None)
        v = constrain(v, dp, None, None, None)

    def core(q, k, v):
        if blockwise:
            return _sdpa_blockwise(q, k, v, mask_kind, cfg.window, cd)
        mask = make_mask(s, skv, mask_kind, cfg.window, device=q.device)
        return _sdpa(q, k, v, mask, cd)

    out = _on_local_heads(core, q, k, v) if is_dtensor(q) else core(q, k, v)
    out = merge_dims(out, 2, 2) @ p.wo.to(cd)
    return out, (k, v)


def _cache_write(cache: torch.Tensor, wpos: torch.Tensor,
                 val: torch.Tensor) -> None:
    """In place: ``cache[b, wpos[b]] = val[b]`` for every row b of a
    (B, S, KV, D) cache.  A DTensor cache (batch, sequence or heads
    sharded, as ``sharding.policy.cache_specs`` places it) is written
    shard by shard: each shard takes its rows' values and writes the
    slots that fall in its part of the sequence."""
    from ..kernels.common import is_dtensor
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, wpos] = val.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, cache.placements
    # the values follow the cache's batch and head shardings
    vpl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
           else Replicate() for p in pl]
    local = cache.to_local()
    shape, off = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    if is_dtensor(val):
        val = val.redistribute(mesh, vpl).to_local()
    else:
        val = val[off[0]:off[0] + shape[0], off[2]:off[2] + shape[2]]
    wl = wpos[off[0]:off[0] + shape[0]] - off[1]
    mine = (wl >= 0) & (wl < shape[1])
    slot = wl.clamp(0, shape[1] - 1)
    rows = torch.arange(shape[0], device=local.device)
    local[rows, slot] = torch.where(mine[:, None, None], val.to(local.dtype),
                                    local[rows, slot])


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
    _cache_write(cache_k, wpos, k[:, 0])
    _cache_write(cache_v, wpos, v[:, 0])
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
    q = split_dim(x @ p.wq.to(cd), 2, (cfg.num_heads, cfg.head_dim))
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
