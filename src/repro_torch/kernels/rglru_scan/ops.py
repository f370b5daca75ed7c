"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``), with the
contract of the JAX package's ``rglru_scan`` op: float32 output, ``(h,
h[:, -1])``.  The kernel needs no padding: its grid covers W with a
bounds check and each thread walks exactly S steps."""

from __future__ import annotations

from typing import Optional

import torch

from .. import common
from .ref import rglru_scan_ref

__all__ = ["rglru_scan", "launch_rglru_scan"]


def launch_rglru_scan(a, bx, h0, h):
    """The bare launch: unchecked, uncounted, into ``h`` (B, S, W) f32;
    ``h0`` is a float32 (B, W) tensor or None."""
    b, s, w = a.shape
    common.raise_on("rglru_scan", common.library().rt_rglru_scan(
        a.data_ptr(), bx.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), b, s, w, common.DTYPE_CODE[a.dtype],
        common.stream(a.device)))


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
