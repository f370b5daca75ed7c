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
        self.router = _param(init_dense(gen, (d, e), torch.float32, device),
                             ("embed", "expert"))
        self.w_gate = _param(init_dense(gen, (e, d, f), dtype, device),
                             ("expert", "embed", "mlp"))
        self.w_up = _param(init_dense(gen, (e, d, f), dtype, device),
                           ("expert", "embed", "mlp"))
        self.w_down = _param(init_dense(gen, (e, f, d), dtype, device),
                             ("expert", "mlp", "embed"))


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


def _dispatch(r: Routing, cfg, x: torch.Tensor):
    """The (B, E, C, d) capacity buffers of routing ``r`` over x (B, S,
    d), and per assignment (token-major) its slot in them, whether it
    was kept and its gate weight."""
    b, s, d = x.shape
    cd = x.dtype
    e, k = cfg.n_experts, cfg.top_k
    n = s * k
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

    # each assignment (token-major) reads its slot back
    unsort = torch.empty_like(r.order).scatter_(
        1, r.order, torch.arange(n, device=x.device).expand(b, n))
    keep = torch.gather(r.keep, 1, unsort)
    pos = torch.gather(torch.where(r.keep, sorted_e * cap + r.rank, 0), 1,
                       unsort)
    w_tok = (r.gates.reshape(b, n) * keep).to(cd)
    return buf, pos, keep, w_tok


def _swiglu(buf, w_gate, w_up, w_down):
    """The per-expert SwiGLU over capacity buffers (B, E, C, d)."""
    cd = buf.dtype
    h = F.silu(torch.einsum("becd,edf->becf", buf, w_gate.to(cd)))
    h = h * torch.einsum("becd,edf->becf", buf, w_up.to(cd))
    return torch.einsum("becf,efd->becd", h, w_down.to(cd))


def _experts(p: MoE, buf: torch.Tensor):
    """The per-expert SwiGLU over the capacity buffers (B, E, C, d).  On
    DTensors each rank runs its own rows and its part of the experts on
    plain local tensors (``local_map``): expert-parallel over "model"
    where E divides it (JAX's layout, ``repro/models/moe.py:131-133``),
    else d_ff-parallel where d_ff divides (the output a partial sum),
    else whole; the weights' gradients are partial sums over the rows'
    mesh dims."""
    from ..kernels.common import is_dtensor
    if not is_dtensor(buf):
        return _swiglu(buf, p.w_gate, p.w_up, p.w_down)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .layers import _mesh_split

    mesh = buf.device_mesh
    names, dp, model, ways = _mesh_split(mesh)
    e, f = p.w_gate.shape[0], p.w_gate.shape[2]
    ep = ways > 1 and e % ways == 0
    tp = not ep and ways > 1 and f % ways == 0

    def pl(on_model, on_rows=Shard(0), off=Replicate()):
        return [on_rows if i in dp else on_model if i in model else off
                for i in range(len(names))]

    buf_pl = pl(Shard(1) if ep else Replicate())
    wgu_pl = pl(Shard(0) if ep else Shard(2) if tp else Replicate(),
                on_rows=Replicate())
    wd_pl = pl(Shard(0) if ep else Shard(1) if tp else Replicate(),
               on_rows=Replicate())
    out_pl = pl(Shard(1) if ep else Partial() if tp else Replicate())
    buf_grad = pl(Partial() if tp else buf_pl[model[0]] if model
                  else Replicate())

    def grads(w_pl):
        return [Partial() if i in dp else q for i, q in enumerate(w_pl)]

    from ..kernels.common import dense_grad

    def local(*xs):
        # shards of the experts' d_ff are strided views (dense operands
        # for the products' backward, dense gradients for DTensor's views)
        return _swiglu(*(dense_grad(t.contiguous()) for t in xs))

    return local_map(local, out_placements=out_pl,
                     in_placements=(buf_pl, wgu_pl, wgu_pl, wd_pl),
                     in_grad_placements=(buf_grad, grads(wgu_pl),
                                         grads(wgu_pl), grads(wd_pl)),
                     redistribute_inputs=True, device_mesh=mesh)(
        buf, p.w_gate, p.w_up, p.w_down)


def _combine(out: torch.Tensor, pos, keep, w_tok, k: int):
    """y (B, S, d): each token's kept assignments read back from ``out``
    (B, E, C, d), weighted by their gates and summed over k."""
    b, e, cap, d = out.shape
    n = pos.shape[1]
    vals = torch.gather(out.reshape(b, e * cap, d), 1,
                        pos[..., None].expand(-1, -1, d))
    vals = vals * keep[..., None].to(out.dtype)
    return (vals * w_tok[..., None]).reshape(b, n // k, k, d).sum(dim=2)


def _moe_ffn(p: MoE, cfg, x: torch.Tensor, train: bool):
    from ..kernels.common import is_dtensor
    if is_dtensor(x):
        return _moe_ffn_sharded(p, cfg, x, train)
    r = route(p, cfg, x, train)
    buf, pos, keep, w_tok = _dispatch(r, cfg, x)
    return _combine(_experts(p, buf), pos, keep, w_tok, cfg.top_k), r.aux


def _moe_ffn_sharded(p: MoE, cfg, x, train: bool):
    """``_moe_ffn`` on a DTensor, in JAX's layouts
    (``repro/models/moe.py:108-147``): each data shard routes, dispatches
    and combines its own batch rows (``local_map`` over batch-over-data),
    so the routing integers are the rows' own and no integer op meets
    DTensor; the experts' MLP runs expert-parallel over "model" where
    the experts divide it (:func:`_experts`); the balance loss is taken
    from the shards' row sums, so it is the global one."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .layers import _mesh_split

    mesh = x.device_mesh
    names, dp, _, _ = _mesh_split(mesh)
    rows = [Shard(0) if i in dp else Replicate() for i in range(len(names))]
    summed = [Partial() if i in dp else Replicate()
              for i in range(len(names))]
    rep = [Replicate()] * len(names)
    e, k = cfg.n_experts, cfg.top_k

    def dispatch(x_l, router_l):
        r = route(SimpleNamespace(router=router_l), cfg, x_l, train)
        buf, pos, keep, w_tok = _dispatch(r, cfg, x_l)
        probs = torch.softmax(x_l.float() @ router_l, dim=-1)
        first = F.one_hot(r.idx[..., 0], e).float()
        # per-row sums: their sum over the rows is DTensor's to take
        return (buf, pos, keep, w_tok, probs.sum(dim=1), first.sum(dim=1))

    # the router's gradient from a data shard is that shard's part
    buf, pos, keep, w_tok, p_row, f_row = local_map(
        dispatch, out_placements=(rows,) * 6, in_placements=(rows, rep),
        in_grad_placements=(rows, summed), device_mesh=mesh,
        redistribute_inputs=True)(x, p.router)
    out = _experts(p, buf)
    y = local_map(lambda o, ps, kp, w: _combine(o, ps, kp, w, k),
                  out_placements=rows, in_placements=(rows, rows, rows, rows),
                  device_mesh=mesh, redistribute_inputs=True)(
        out, pos, keep, w_tok)
    tokens = x.shape[0] * x.shape[1]
    me, ce = p_row.sum(dim=0) / tokens, f_row.sum(dim=0) / tokens
    aux = e * torch.sum(me * ce)
    return y, aux


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
