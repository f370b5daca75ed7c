"""Plain PyTorch version of the RG-LRU scan kernel: the recurrence
step by step, in float32."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rglru_scan_ref"]


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + bx_t over axis 1.  a, bx (B, S, W) in any float
    type, computed in float32; h0 optional (B, W).  Returns (h (B, S, W)
    float32, h_last (B, W))."""
    a, bx = a.float(), bx.float()
    b, s, w = a.shape
    h = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    state = (torch.zeros((b, w), dtype=torch.float32, device=a.device)
             if h0 is None else h0.float())
    for t in range(s):
        state = a[:, t] * state + bx[:, t]
        h[:, t] = state
    return h, h[:, -1]
