"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``), with the
contract of the JAX package's ``rglru_scan`` op: float32 output, ``(h,
h[:, -1])``.  The kernel needs no padding: it masks the ragged chunk
and column tile itself.  Its chunked scan passes carries between blocks
through a scratch of flags, aggregates and prefixes, which this module
allocates and zeroes once per device and stream and reuses: each launch
carries a new epoch in its flags, so no launch needs a fill."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import common
from .ref import rglru_scan_ref

__all__ = ["rglru_scan", "launch_rglru_scan"]

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


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + bx_t.  a, bx (B, S, W), float32 or bfloat16,
    one type; h0 optional (B, W), float32.  Returns (h (B, S, W) float32,
    h_last (B, W)).  The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got {tuple(a.shape)}")
    dev = a.device
    common.check("a", a, a.shape, dev)
    common.check("bx", bx, a.shape, dev, a.dtype)
    b, s, w = a.shape
    if h0 is not None:
        common.check("h0", h0, (b, w), dev, torch.float32)
    if not common.route(dev):
        return rglru_scan_ref(a, bx, h0)
    h = torch.empty((b, s, w), dtype=torch.float32, device=dev)
    if h.numel():
        launch_rglru_scan(a, bx, h0, h)
        common.LAUNCHES["rglru_scan"] += 1
    return h, h[:, -1]
