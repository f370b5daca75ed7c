"""Mamba-2 (SSD, state-space duality) block.

The port of the JAX package's ``models/ssm.py``.  Prefill and training
run the chunked SSD scan through ``repro_torch.kernels.ssd_chunk_scan``
— the hand-written kernel on the card, its plain version on the CPU;
in training the card's backward is a kernel too (``ssd_scan_bwd``),
where the JAX package differentiates its jnp reference — and decoding
is the O(1) recurrence on a (B, H, N, P) f32 state.

Layout follows the reference Mamba-2: in_proj -> [z | x | B | C | dt],
causal conv over (x, B, C), per-head scalar decay A, D skip, gated
RMSNorm, out_proj.  n_groups = 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_chunk_scan
from .layers import init_dense, merge_dims, rms_norm, split_dim

__all__ = ["SSM", "ssd_forward", "ssm_decode_step", "init_ssm_state"]


def _param(t: torch.Tensor, axes) -> nn.Parameter:
    """A trainable parameter (the serving entry points run under
    ``torch.no_grad``) that carries its logical axes, one name (or None)
    a dimension, as the JAX package's ``init`` returns them beside the
    params; ``repro_torch.sharding.policy`` maps them to mesh axes."""
    if len(axes) != t.dim():
        raise ValueError(f"{len(axes)} logical axes {axes} for a "
                         f"{t.dim()}-d parameter")
    p = nn.Parameter(t)
    p.logical_axes = tuple(axes)
    return p


class SSM(nn.Module):
    """The block's parameters, named as the JAX package's ``init_ssm``
    names them."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        w = cfg.conv_width
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = _param(init_dense(gen, (d, 2 * di + 2 * n + h), dtype,
                                         device), ("embed", "ssm_in"))
        self.conv_w = _param(init_dense(gen, (w, di + 2 * n), dtype, device,
                                        scale=w ** -0.5), (None, "ssm_conv"))
        self.conv_b = _param(torch.zeros(di + 2 * n, dtype=dtype,
                                         device=device), ("ssm_conv",))
        self.A_log = _param(torch.log(torch.linspace(1.0, 16.0, h, **f32)),
                            ("ssm_heads",))
        self.D = _param(torch.ones(h, **f32), ("ssm_heads",))
        self.dt_bias = _param(torch.zeros(h, **f32), ("ssm_heads",))
        self.norm = _param(torch.ones(di, dtype=dtype, device=device),
                           ("ssm_inner",))
        self.out_proj = _param(init_dense(gen, (di, d), dtype, device),
                               ("ssm_inner", "embed"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B,S,C), w (W,C).  With ``state``
    (B, W-1, C) it is a streaming step (S may be 1); returns the new
    state, the last W-1 inputs."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+W-1, C)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(width - 1):]
    return out + b, new_state


def _split_in(cfg, zxbcdt):
    """in_proj's output -> z, x, B, C, dt (JAX's split indices as sizes)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def ssd_forward(p: SSM, cfg, x: torch.Tensor):
    """Full-sequence SSD block (prefill / forward).  Returns (y (B,S,d),
    (conv_state, ssm_state)) for the cache; the state is f32."""
    b, s, _ = x.shape
    cd = x.dtype
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xc, bm, cm, dt = _split_in(cfg, x @ p.in_proj.to(cd))
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p.conv_w.to(cd),
                                        p.conv_b.to(cd))
    conv_out = F.silu(conv_out)
    xc, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)                      # (B,S,H)
    a_log = -torch.exp(p.A_log)[None, None, :] * dt              # (B,S,H)
    xh = split_dim(xc, 2, (h, pd))
    xbar = xh * dt.to(cd)[..., None]
    y, hfin = ssd_chunk_scan(xbar, a_log, bm.contiguous(), cm.contiguous(),
                             chunk=cfg.ssm_chunk)
    y = y + xh * p.D.to(cd)[None, None, :, None]
    y = merge_dims(y, 2, 2)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.out_proj.to(cd), (conv_state, hfin)


def init_ssm_state(cfg, batch: int, dtype, device=None):
    """(conv_state (B, W-1, di+2N), ssm_state (B, H, N, P))."""
    di, n = cfg.d_inner, cfg.ssm_state
    conv = torch.zeros((batch, cfg.conv_width - 1, di + 2 * n), dtype=dtype,
                       device=device)
    ssm = torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                      dtype=dtype, device=device)
    return conv, ssm


def ssm_decode_step(p: SSM, cfg, x: torch.Tensor, state):
    """One-token recurrence.  x (B,1,d); state (conv_state, ssm_state).

    The state stays f32 (the prefill leaves it f32, and ``h * a`` keeps
    it so).  The readout C h is taken in f32 and cast to the compute
    type, as the prefill's scan output is.  (The JAX function leaves it
    f32, which at a bf16 compute type turns the block's output f32 and
    stops its decode scan with a carry-type error; at f32 the cast
    changes nothing.)"""
    conv_state, hstate = state
    b = x.shape[0]
    cd = x.dtype
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xc, bm, cm, dt = _split_in(cfg, x @ p.in_proj.to(cd))
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p.conv_w.to(cd),
                                        p.conv_b.to(cd), conv_state)
    conv_out = F.silu(conv_out)
    xc, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)                      # (B,1,H)
    a = torch.exp(-torch.exp(p.A_log)[None, :] * dt[:, 0])       # (B,H)
    xh = split_dim(xc[:, 0], 1, (h, pd))
    xbar = xh * dt[:, 0, :, None].to(cd)
    # h <- a h + B (x dt)^T ; y = C h + D x
    upd = torch.einsum("bn,bhp->bhnp", bm[:, 0], xbar)
    hstate = hstate * a[:, :, None, None].to(cd) + upd
    y = torch.einsum("bn,bhnp->bhp", cm[:, 0].to(hstate.dtype),
                     hstate).to(cd)
    y = y + xh * p.D.to(cd)[None, :, None]
    y = merge_dims(y, 1, 2)[:, None]
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.out_proj.to(cd), (conv_state, hstate)
