"""Pipeline parallelism (GPipe schedule) over ``torch.distributed``.

The port of the JAX package's ``sharding/pipeline.py``.
``pipeline(stage_fn, mesh)`` runs a stack of S stages (parameters
stacked on a leading axis, one stage a rank of the mesh's ``stage``
dimension) over M microbatches with the classic skewed clock: tick t
feeds stage s the microbatch (t - s), and activations hop stage to
stage.  So:

  * the forward fills and drains the pipeline in M + S - 1 ticks
    (bubble fraction (S-1)/(M+S-1), the standard GPipe bubble);
  * a hop is a ``torch.autograd.Function`` over paired
    ``batch_isend_irecv`` (every rank sends to the next and receives
    from the previous, cyclically, as JAX's ``ppermute``), whose
    backward is the reverse shift — the backward pipeline;
  * each stage's activations are recomputed in the backward
    (``torch.utils.checkpoint``) with ``remat_stage``, bounding what is
    stashed to one microbatch a tick a stage;
  * the last stage collects the outputs, and a sum over the stage group
    (JAX's ``psum``) gives every rank the result; its backward passes
    each rank's own cotangent through (every rank holds the same loss).

Every rank runs every tick; stage 0 selects its feed, and the other
stages keep their zero outputs, with a ``where`` that keeps the hop and
the stage in the graph (as JAX's does), so each rank's backward runs
the same hops in the same order and the paired sends and receives
meet.  The gradient of the stacked parameters on a
rank holds that rank's stage (zeros elsewhere); their sum over the
stage group is the whole gradient, as JAX's is sharded over the axis.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.utils.checkpoint as ckpt

__all__ = ["pipeline"]


def _shift(t: torch.Tensor, step: int, group) -> torch.Tensor:
    """This rank's ``t`` to the rank ``step`` after it in ``group``
    (cyclically); returns what the rank ``step`` before it sent."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, dist.get_global_rank(group,
                                                       (me + step) % n),
                   group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group,
                                                         (me - step) % n),
                   group)])
    for req in reqs:
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """One forward hop of the ring; its backward, the reverse hop."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _shift(y, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -1, ctx.group), None


class _SumOverStages(torch.autograd.Function):
    """The sum of ``x`` over the stage group; the backward passes the
    cotangent through (every rank computes the same loss from it)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        if dist.get_world_size(group) > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline(stage_fn: Callable, mesh, axis: str = "stage",
             remat_stage: bool = True):
    """Build a pipelined apply: (stacked_params, microbatches) -> outputs.

    ``stage_fn(params_slice, x) -> y`` maps (B, ...) -> (B, ...) with
    the same shape and dtype (a residual-stream stage).  ``mesh`` is a
    ``DeviceMesh`` with an ``axis`` dimension (one stage a rank of it).

    stacked_params: dict of tensors with leading dim S (the same on
    every rank; each rank uses its slice); microbatches: (M, B, ...)
    (the same on every rank).  Returns the last stage's (M, B, ...)
    outputs on every rank."""
    group = mesh.get_group(axis)
    n_stage = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)

    def fn(params: Dict[str, torch.Tensor], x):
        if remat_stage:
            return ckpt.checkpoint(stage_fn, params, x, use_reentrant=False)
        return stage_fn(params, x)

    def run(params: Dict[str, torch.Tensor], mb: torch.Tensor):
        m = mb.shape[0]
        p_here = {k: v[sid] for k, v in params.items()}
        first = torch.tensor(sid == 0, device=mb.device)
        last = torch.tensor(sid == n_stage - 1, device=mb.device)
        state = torch.zeros_like(mb[0])          # the current activation
        outs = [torch.zeros_like(mb[0]) for _ in range(m)]
        for t in range(m + n_stage - 1):
            # stage 0 ingests microbatch t (clipped, as JAX's)
            feed = mb[min(max(t, 0), m - 1)]
            y = fn(p_here, torch.where(first, feed, state))
            # the last stage emits microbatch t - S + 1; the others keep
            # their zeros through a where, so every rank's loss reaches
            # every tick and each rank's backward runs every hop
            out_idx = t - (n_stage - 1)
            if out_idx >= 0:
                outs[out_idx] = torch.where(last, y, outs[out_idx])
            state = _Hop.apply(y, group)
        # only the last stage wrote its outputs (the others hold zeros),
        # so a sum over the stages gives every rank the result
        return _SumOverStages.apply(torch.stack(outs), group)

    return run
