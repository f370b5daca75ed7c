"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of the JAX package's ``models/moe.py``.  Each batch row routes
its own tokens: the router's f32 softmax picks ``top_k`` experts a
token, the row's assignments are sorted by expert (stably, so ties keep
token order), each expert keeps its first ``cap`` assignments, and the
kept ones fill a (B, E, C, d) capacity buffer on which the per-expert
SwiGLU runs as dense einsums.  The outputs go back per assignment,
weighted by the renormalised gates of the kept ones and summed over k.
The Switch-style balance loss comes back beside the output.

The integers are the JAX package's: the same top-k (the lower expert
first on a tie), the same sort order, ranks, kept set and buffer slots,
so the same assignments are dropped.  The JAX code avoids scatters for
its SPMD partitioner; this one gathers where that is simpler.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import init_dense
from .ssm import _param

__all__ = ["MoE", "Routing", "route", "moe_ffn", "MOE_CHUNK"]

#: tokens a call routes at once; longer multiples are cut into chunks
#: so that the capacity buffers stay O(chunk)
MOE_CHUNK = 8192


class MoE(nn.Module):
    """The router (d, E), always float32, and the experts' SwiGLU
    weights (E, d, f), (E, d, f), (E, f, d) in the model's type."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
        self.router = _param(init_dense(gen, (d, e), torch.float32, device))
        self.w_gate = _param(init_dense(gen, (e, d, f), dtype, device))
        self.w_up = _param(init_dense(gen, (e, d, f), dtype, device))
        self.w_down = _param(init_dense(gen, (e, f, d), dtype, device))


class Routing(NamedTuple):
    """One call's routing, per batch row: ``idx`` (B, S, k) experts and
    ``gates`` (B, S, k) their renormalised weights; over the row's
    assignments (token-major, n = S k): ``order`` the stable sort by
    expert, ``sorted_e`` the experts in that order, ``seg_start`` (B, E)
    where each expert's run begins in it, ``rank`` (in sorted order) each
    assignment's place in its expert, ``keep`` (in sorted order) rank <
    ``cap``; ``aux`` the balance loss."""
    idx: torch.Tensor
    gates: torch.Tensor
    order: torch.Tensor
    sorted_e: torch.Tensor
    seg_start: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def route(p: MoE, cfg, x: torch.Tensor, train: bool) -> Routing:
    """Route x (B, S, d); ``train`` picks ``capacity_factor`` (drops
    tolerated) over ``capacity_factor_eval``."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = s * k
    cf = cfg.capacity_factor if train else cfg.capacity_factor_eval
    cap = max(1, min(s, int(math.ceil(s * k / e * cf))))

    probs = torch.softmax(x.float() @ p.router, dim=-1)         # (B,S,E)
    # top-k as a stable descending sort: on a tie the lower expert
    # comes first, as jax.lax.top_k has it
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    flat_e = idx.reshape(b, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_start = torch.searchsorted(sorted_e, torch.arange(
        e, device=x.device).expand(b, e).contiguous())          # (B, E)
    rank = (torch.arange(n, device=x.device)[None, :]
            - torch.gather(seg_start, 1, sorted_e))
    return Routing(idx, gates, order, sorted_e, seg_start, rank,
                   rank < cap, cap, aux)


def _moe_ffn(p: MoE, cfg, x: torch.Tensor, train: bool):
    b, s, d = x.shape
    cd = x.dtype
    e, k = cfg.n_experts, cfg.top_k
    n = s * k
    r = route(p, cfg, x, train)
    cap, sorted_e, seg_start = r.cap, r.sorted_e, r.seg_start
    counts = torch.cat([seg_start[:, 1:], torch.full(
        (b, 1), n, dtype=seg_start.dtype, device=x.device)], 1) - seg_start

    # slot (e, c) holds sorted assignment seg_start[e] + c when c is
    # below the expert's count (and the capacity)
    slots = torch.arange(cap, device=x.device)
    slot_src = (seg_start[:, :, None] + slots).reshape(b, e * cap)
    valid = (slots < counts[:, :, None]).reshape(b, e * cap, 1)
    token_of = torch.gather(r.order // k, 1, slot_src.clamp(0, n - 1))
    buf = torch.gather(x, 1, token_of[..., None].expand(-1, -1, d))
    buf = (buf * valid.to(cd)).reshape(b, e, cap, d)

    # per-expert SwiGLU over the capacity buffers
    h = F.silu(torch.einsum("becd,edf->becf", buf, p.w_gate.to(cd)))
    h = h * torch.einsum("becd,edf->becf", buf, p.w_up.to(cd))
    out = torch.einsum("becf,efd->becd", h, p.w_down.to(cd))

    # combine: each assignment (token-major) reads its slot back
    unsort = torch.empty_like(r.order).scatter_(
        1, r.order, torch.arange(n, device=x.device).expand(b, n))
    keep = torch.gather(r.keep, 1, unsort)
    pos = torch.gather(torch.where(r.keep, sorted_e * cap + r.rank, 0), 1,
                       unsort)
    vals = torch.gather(out.reshape(b, e * cap, d), 1,
                        pos[..., None].expand(-1, -1, d))
    vals = vals * keep[..., None].to(cd)
    w_tok = (r.gates.reshape(b, n) * keep).to(cd)
    y = (vals * w_tok[..., None]).reshape(b, s, k, d).sum(dim=2)
    return y, r.aux


def moe_ffn(p: MoE, cfg, x: torch.Tensor, train: bool = True):
    """x (B, S, d) -> (y (B, S, d), aux f32 scalar).  A sequence longer
    than :data:`MOE_CHUNK` and a multiple of it is routed chunk by chunk,
    its aux the mean over the chunks."""
    s = x.shape[1]
    if s > MOE_CHUNK and s % MOE_CHUNK == 0:
        ys, auxs = [], []
        for i in range(s // MOE_CHUNK):
            y, aux = _moe_ffn(p, cfg, x[:, i * MOE_CHUNK:(i + 1) * MOE_CHUNK],
                              train)
            ys.append(y)
            auxs.append(aux)
        return torch.cat(ys, dim=1), torch.stack(auxs).mean()
    return _moe_ffn(p, cfg, x, train)
