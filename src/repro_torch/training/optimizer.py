"""AdamW with global-norm clipping over dicts of tensors.

The port of the JAX package's ``training/optimizer.py``, with its f32
arithmetic in its order: clip by the global norm, moments from the
clipped gradient, bias correction from ``step + 1``, ``eps`` outside the
square root, weight decay on every leaf (norms included), and the update
taken from the f32 master copy in ``master_weights`` mode.
``torch.optim.AdamW`` orders these differently (decay before the step,
``eps`` scaled by the bias correction), so it is not used.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``).  Where the JAX function returns
new trees, :func:`adamw_update` updates the parameters and moments in
place, a leaf at a time: at recurrentgemma-9b's width a second copy of
the parameters, or the whole-list temporaries of ``torch._foreach_*``,
would not fit beside them on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "global_norm"]

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # Mixed precision: low-precision live params + an f32 master copy in
    # the optimizer state; the update math stays f32.
    master_weights: bool = False


class OptState(NamedTuple):
    m: Tree
    v: Tree
    step: torch.Tensor               # int32, 0-d, on the parameters' device
    master: Optional[Tree] = None    # f32 params (master_weights mode)


def init_opt_state(params: Tree, master_weights: bool = False) -> OptState:
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    master = ({k: p.detach().float().clone() for k, p in params.items()}
              if master_weights else None)
    return OptState(m=zeros,
                    v={k: torch.zeros_like(z) for k, z in zeros.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev),
                    master=master)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = [torch.linalg.vector_norm(x.detach(), 2, dtype=torch.float32)
             for x in tree.values()]
    return torch.linalg.vector_norm(torch.stack(norms), 2)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState, lr_scale=1.0):
    """Returns (params, new_state, metrics); ``params`` and the moments
    are updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * lr_scale
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        w = state.master[name] if state.master is not None else p
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(g.mul_(g), alpha=1 - cfg.b2)
        denom = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
        delta = torch.div(m, b1c).div_(denom)
        del g, denom
        wf = w if w.dtype == torch.float32 else w.float()
        delta.add_(wf, alpha=cfg.weight_decay).mul_(lr)
        if wf is w:
            w.sub_(delta)
        else:
            w.copy_(wf.sub_(delta))
        if w is not p:
            p.copy_(w)
    return params, OptState(state.m, state.v, step, state.master), {
        "grad_norm": gnorm, "clip_scale": scale}
