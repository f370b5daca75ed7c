"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Block: x -> [W_in -> causal conv -> RG-LRU] * GeLU(W_gate x) -> W_out,
with the recurrence (arXiv:2402.19427)

    r_t = sigmoid(w_r * u_t + b_r)          (recurrence gate)
    i_t = sigmoid(w_i * u_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The port of the JAX package's ``models/rglru.py``.  Prefill evaluates
the linear recurrence through ``repro_torch.kernels.rglru_scan`` — the
hand-written kernel on the card, its plain version on the CPU; decoding
is the O(1) step on a (B, W) f32 state.  GeLU is the tanh approximation,
``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.rglru_scan.ops import rglru_scan
from .layers import init_dense
from .ssm import _causal_conv, _param

__all__ = ["RGLRU", "rglru_forward", "rglru_decode_step", "init_rglru_state"]

_C = 8.0


class RGLRU(nn.Module):
    """The block's parameters, named as the JAX package's ``init_rglru``
    names them; Lambda is set so that a ~ U[0.9, 0.999] at r = 0.5."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        f32 = dict(dtype=torch.float32, device=device)
        self.w_in = _param(init_dense(gen, (d, w), dtype, device),
                           ("embed", "lru"))
        self.w_gate = _param(init_dense(gen, (d, w), dtype, device),
                             ("embed", "lru"))
        self.w_out = _param(init_dense(gen, (w, d), dtype, device),
                            ("lru", "embed"))
        self.conv_w = _param(init_dense(gen, (cfg.conv_width, w), dtype,
                                        device, scale=cfg.conv_width ** -0.5),
                             (None, "lru"))
        self.conv_b = _param(torch.zeros(w, dtype=dtype, device=device),
                             ("lru",))
        self.lam = _param(torch.linspace(0.5, 4.0, w, **f32), ("lru",))
        self.w_r = _param(torch.ones(w, **f32), ("lru",))
        self.b_r = _param(torch.zeros(w, **f32), ("lru",))
        self.w_i = _param(torch.ones(w, **f32), ("lru",))
        self.b_i = _param(torch.zeros(w, **f32), ("lru",))


def _gates(p: RGLRU, u: torch.Tensor):
    """(a, bx) of the recurrence, f32 whatever the compute type."""
    uf = u.float()
    r = torch.sigmoid(uf * p.w_r + p.b_r)
    i = torch.sigmoid(uf * p.w_i + p.b_i)
    a = torch.exp(-_C * F.softplus(p.lam) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, bx


def rglru_forward(p: RGLRU, cfg, x: torch.Tensor,
                  state: Optional[Tuple] = None):
    """Full-sequence block.  x (B,S,d) -> (y (B,S,d), (conv_state,
    h_last)); ``state`` continues from a cache."""
    cd = x.dtype
    u = x @ p.w_in.to(cd)
    u, conv_state = _causal_conv(u, p.conv_w.to(cd), p.conv_b.to(cd),
                                 None if state is None else state[0])
    a, bx = _gates(p, u)
    h, h_last = rglru_scan(a, bx, None if state is None else state[1])
    y = h.to(cd) * F.gelu(x @ p.w_gate.to(cd), approximate="tanh")
    return y @ p.w_out.to(cd), (conv_state, h_last)


def init_rglru_state(cfg, batch: int, dtype, device=None):
    w = cfg.lru_width or cfg.d_model
    conv = torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                       device=device)
    h = torch.zeros((batch, w), dtype=torch.float32, device=device)
    return conv, h


def rglru_decode_step(p: RGLRU, cfg, x: torch.Tensor, state):
    """One-token step.  x (B,1,d); state (conv_state, h)."""
    conv_state, h = state
    cd = x.dtype
    u = x @ p.w_in.to(cd)
    u, conv_state = _causal_conv(u, p.conv_w.to(cd), p.conv_b.to(cd),
                                 conv_state)
    a, bx = _gates(p, u[:, 0])
    h = a * h + bx
    y = h[:, None].to(cd) * F.gelu(x @ p.w_gate.to(cd), approximate="tanh")
    return y @ p.w_out.to(cd), (conv_state, h)
