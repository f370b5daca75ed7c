"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``), with the
contract of the JAX package's ``rglru_scan`` op: float32 output, ``(h,
h[:, -1])``.  The kernel needs no padding: it masks the ragged chunk
and column tile itself.  Its chunked scan passes carries between blocks
through a scratch of flags, aggregates and prefixes, which this module
allocates and zeroes once per device and stream and reuses: each launch
carries a new epoch in its flags, so no launch needs a fill.

The scan is differentiable, and its backward is a second launch of the
same kernel.  The JAX package has no backward kernel (its training
differentiates the jnp reference); but the gradient of a linear
recurrence is the same recurrence run backwards in time.  With G_t =
dL/dh_t in total, G_{S-1} = dh_{S-1} and G_t = dh_t + a_{t+1} G_{t+1},
so flip(G) = scan(c, e) with c = (0, a_{S-1}, ..., a_1) and e = flip(dh)
(the gradient of h[:, -1] reaches dh through autograd); then dbx = G,
da = G h_prev (h_prev = (h0 or 0, h_0, ..., h_{S-2})) and dh0 = a_0 G_0.
The reversed launch runs in float32 on the card (counted under
``rglru_scan_bwd``) and through the plain version on the CPU, so both
take one formula.

On ``meta`` tensors each launch only allocates its output, counted by
the dry-run as the roofline's RG-LRU term: 8 B S W flops a forward (the
gates and the scan, ``launch/roofline.py``), twice that a backward.  A
DTensor reaches the kernel as its local shard with the batch and width
sharded at most: the recurrence runs along S, which is gathered first.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import common
from .ref import rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_backward", "launch_rglru_scan"]

# (device index, stream) -> [int32 scratch, epoch of its last launch]
_SCRATCH: Dict[Tuple[int, int], list] = {}


def _scratch(lib, device: torch.device, stream: int, b: int, s: int,
             w: int):
    """The scratch of a launch on ``stream`` at this shape and the epoch
    the launch carries: a zeroed buffer, allocated anew when it is too
    small or its epochs have run out."""
    words = lib.rt_rglru_scan_scratch(b, s, w)
    if words < 0:
        raise ValueError(f"rglru_scan: ({b}, {s}, {w}) needs a scratch of "
                         f"2^31 words or more")
    key = (device.index, stream)
    entry = _SCRATCH.get(key)
    if (entry is None or entry[0].numel() < words
            or entry[1] + 1 >= lib.rt_rglru_scan_epochs()):
        entry = [torch.zeros(words, dtype=torch.int32, device=device), 0]
        _SCRATCH[key] = entry
    entry[1] += 1
    return entry[0], entry[1]


def launch_rglru_scan(a, bx, h0, h):
    """The bare launch: unchecked, uncounted, into ``h`` (B, S, W) f32;
    ``h0`` is a float32 (B, W) tensor or None."""
    b, s, w = a.shape
    lib = common.library()
    stream = common.stream(a.device)
    scratch, epoch = _scratch(lib, a.device, stream, b, s, w)
    common.raise_on("rglru_scan", lib.rt_rglru_scan(
        a.data_ptr(), bx.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), scratch.data_ptr(), b, s, w,
        common.DTYPE_CODE[a.dtype], epoch, stream))


def _scan(a, bx, h0, key: str):
    """h of the recurrence: the kernel, counted under ``key``, on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not common.route(a.device):
        return rglru_scan_ref(a, bx, h0)[0]
    if a.device.type == "meta":
        b, s, w = a.shape
        per = 8 * b * s * w * (2 if key == "rglru_scan_bwd" else 1)
        return common.meta_out(a, list(a.shape), torch.float32, per)
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if h.numel():
        launch_rglru_scan(a, bx, h0, h)
        common.LAUNCHES[key] += 1
    return h


def rglru_scan_backward(a, h, h0, dh):
    """(da, dbx, dh0) of the scan that gave ``h`` (B, S, W) f32 from
    ``a`` and ``h0`` (None or (B, W)), for the gradient ``dh`` of h:
    the reversed recurrence, one launch of the kernel on the card.
    Returned in float32; dh0 is None without h0."""
    b, s, w = a.shape
    c = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    c[:, 0] = 0.0
    c[:, 1:] = a[:, 1:].flip(1)
    e = dh.flip(1).float().contiguous()
    g = _scan(c, e, None, "rglru_scan_bwd").flip(1)
    h_prev = torch.empty_like(h)
    h_prev[:, 1:] = h[:, :-1]
    if h0 is None:
        h_prev[:, 0] = 0.0
    else:
        h_prev[:, 0] = h0
    dh0 = None if h0 is None else a[:, 0].float() * g[:, 0]
    return g * h_prev, g, dh0


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, bx, h0):
        h = _scan(a, bx, h0, "rglru_scan")
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, dbx, dh0 = rglru_scan_backward(a, h, h0, dh)
        return (da.to(a.dtype) if ctx.needs_input_grad[0] else None,
                dbx.to(a.dtype) if ctx.needs_input_grad[1] else None,
                dh0 if ctx.needs_input_grad[2] else None)


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + bx_t.  a, bx (B, S, W), float32 or bfloat16,
    one type; h0 optional (B, W), float32.  Returns (h (B, S, W) float32,
    h_last (B, W)).  The kernel on a CUDA tensor, the plain version on a
    CPU tensor; differentiable in a, bx and h0 (the backward is the
    reversed scan, :func:`rglru_scan_backward`).  DTensors run on their
    local shards, sharded over B and W at most."""
    if common.is_dtensor(a):
        bw = {0: 0, 2: 2}
        h = common.local_call(
            lambda a_, bx_, h0_: rglru_scan(
                a_.contiguous(), bx_.contiguous(),
                None if h0_ is None else h0_.contiguous())[0],
            (a, bx, h0), (bw, bw, {0: 0, 2: 1} if h0 is not None else None),
            bw)
        return h, h[:, -1]
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got {tuple(a.shape)}")
    dev = a.device
    common.check("a", a, a.shape, dev)
    common.check("bx", bx, a.shape, dev, a.dtype)
    b, s, w = a.shape
    if h0 is not None:
        common.check("h0", h0, (b, w), dev, torch.float32)
    h = _RGLRUScan.apply(a, bx, h0)
    return h, h[:, -1]
