"""What the LM kernels' wrappers share: the launch counts, the route by
device, the checks, the element-type codes of the C entry points.

The wrappers follow the engines' kernel wrappers
(``repro_torch/core/vecsim/kernels/ops.py``): they check their tensors
(device, dtype, shape, contiguity), then a CUDA tensor goes to the
hand-written kernel on PyTorch's current stream — a failed build or
launch raises, there is no fallback — and a CPU tensor to the plain
version.  :data:`LAUNCHES` moves only where a kernel is launched.

Two more routes serve the distributed code (``repro_torch.sharding``):

  * a ``meta`` tensor (the dry-run's abstract cells) takes the kernel's
    route, and where the kernel would be launched its outputs are only
    allocated (:func:`meta_out`, a custom op whose fake kernel gives the
    shapes): no arithmetic runs and no launch is counted; the op's flop
    formula is the roofline's for the layer kind, so the dry-run's
    counter sees the scan's work, not the plain version's steps;
  * a DTensor reaches its kernel as its local shard
    (:func:`local_call`, through ``local_map``): the inputs are first
    redistributed so that only dimensions the kernel treats
    independently (batch, width, heads) stay sharded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["LAUNCHES", "reset_launches"]

#: kernel name -> launches since the last :func:`reset_launches`
#: (``rglru_scan_bwd``: the RG-LRU scan's reversed launch in a backward;
#: ``ssd_scan_bwd``: one SSD scan backward, whatever its launches)
LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_bwd": 0,
                            "ssd_scan": 0, "ssd_scan_bwd": 0,
                            "flash_attention": 0}

# element-type codes of the C entry points (csrc/lm_common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def route(device: torch.device) -> bool:
    """True for the kernel (a ``meta`` tensor follows it to the launch,
    which then only allocates), False for the plain version."""
    if device.type in ("cuda", "meta"):
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"the LM kernels run on 'cuda' or 'cpu' (or 'meta' "
                     f"for shapes), not {device.type!r}")


@torch.library.custom_op("repro_torch::meta_out", mutates_args=())
def meta_out(like: torch.Tensor, shape: List[int], dtype: torch.dtype,
             flops: int) -> torch.Tensor:
    """A kernel's output of ``shape`` and ``dtype`` on ``meta``: the
    launch's stand-in in an abstract trace, doing ``flops`` of work by
    the roofline's count."""
    raise ValueError("meta_out allocates on the meta device only")


@meta_out.register_fake
def _(like, shape, dtype, flops):
    return like.new_empty(shape, dtype=dtype)


@register_flop_formula(torch.ops.repro_torch.meta_out)
def _meta_out_flops(like, shape, dtype, flops, out_shape=None, **kwargs):
    return flops


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient dense: a local
    result's gradient leaves ``local_map`` as a DTensor's local shard,
    and DTensor's own backward views (those of a matmul's reshapes)
    need dense shards."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def dense_grad(x):
    """``x``, its gradient made dense on the way back (:class:`_DenseGrad`)."""
    if isinstance(x, torch.Tensor) and x.requires_grad:
        return _DenseGrad.apply(x)
    return x


def local_call(fn, args: Sequence, in_dims: Sequence, out_dims: Sequence):
    """``fn(*args)`` on the local shards of DTensor ``args``.

    ``in_dims[i]`` maps a dimension of ``args[0]`` that may stay sharded
    to the matching dimension of ``args[i]`` (a dict, or None for an
    argument that is not a tensor); ``args[0]``'s other shardings, and
    every ``Partial``, are redistributed to ``Replicate`` first.
    ``out_dims`` gives the same map for each output of ``fn`` (one
    dict, or a tuple of them).  An input whole on a mesh dim over which
    ``args[0]`` is sharded gets its gradient as a partial sum there.
    Returns DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = args[0]
    mesh = lead.device_mesh

    def place(dims: Optional[dict]):
        if dims is None:
            return None
        # one output's placements are a list (local_map reads a tuple as
        # one entry an output)
        return [Shard(dims[p.dim]) if isinstance(p, Shard)
                and dims.get(p.dim) is not None else Replicate()
                for p in lead.placements]

    def grad_place(dims: Optional[dict]):
        # an input that is whole on a mesh dim over which the lead is
        # sharded gets a partial gradient from each shard there
        if dims is None:
            return None
        return [Partial() if isinstance(p, Shard) and dims.get(p.dim) is None
                else q for p, q in zip(lead.placements, place(dims))]

    multi = isinstance(out_dims, tuple)
    outs = tuple(place(d) for d in out_dims) if multi else place(out_dims)
    live = [(a is not None) for a in args]
    return local_map(lambda *xs: fn(*map(dense_grad, xs)),
                     out_placements=outs,
                     in_placements=tuple(place(d) if ok else None
                                         for ok, d in zip(live, in_dims)),
                     in_grad_placements=tuple(
                         grad_place(d) if ok else None
                         for ok, d in zip(live, in_dims)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def check(name: str, x: torch.Tensor, shape: Tuple[int, ...],
          device: torch.device, dtype=None) -> None:
    """``x`` lies on ``device``, has ``shape`` and is contiguous; with
    ``dtype`` it has that type, without it float32 or bfloat16."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the other inputs on "
                         f"{device}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if dtype is None and x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def library():
    from repro_torch.core.vecsim.kernels import _build
    return _build.load_library()


def raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
