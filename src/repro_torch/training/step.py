"""Train and serve step builders: loss, gradient accumulation, optimizer.

The port of the JAX package's ``training/step.py``.  ``make_train_step``
returns a function

    (params, opt_state, batch) -> (params, opt_state, metrics)

over ``params``, a dict of tensors keyed by parameter name.  The model's
code reads its parameters from its modules, so a step binds ``params``
into the model (:func:`bound`) for the forward and the backward
together: one model serves any number of replicas (the gossip trainer's
pods share it), and a backward that recomputes a superblock (``remat``)
recomputes it from the same tensors.  Passing the model's own
``dict(model.named_parameters())`` binds nothing new.

The batch is a dict of arrays or tensors (``tokens`` or ``embeds``,
``labels``, optionally ``mask``, ``positions`` and, for an
encoder-decoder, ``enc_embeds``); the step moves it to the model's
device.  The loss adds ``aux_coef`` times the model's MoE balance loss.
Microbatching splits its leading axis and sums the gradients in f32,
scaled by ``1 / microbatches``, as the JAX step's scan does.  The
parameters and moments are updated in place (``adamw_update``); the
metrics are 0-d tensors on the device, read by the caller when it wants
them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from .optimizer import AdamWConfig, OptState, adamw_update

__all__ = ["cross_entropy", "bound", "make_loss_fn", "make_grad_fn",
           "make_train_step", "make_prefill_step", "make_decode_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE as ``lse - ll`` (no one-hot); logits f32 (B, S, V),
    labels (B, S) int."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


@contextlib.contextmanager
def bound(model: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """Inside the block, each parameter of ``model`` named in ``params``
    reads as that tensor; the model's own tensors come back after."""
    saved = []
    try:
        for name, t in params.items():
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield model
    finally:
        for mod, leaf, t in reversed(saved):
            mod._parameters[leaf] = t


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if v is not None}


def _model_inputs(batch):
    return {k: batch.get(k) for k in ("tokens", "positions", "embeds",
                                      "enc_embeds")}


def _loss(model, batch, aux_coef):
    logits, aux = model.forward_aux(**_model_inputs(batch))
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def make_loss_fn(model, aux_coef: float = 1e-2):
    """loss_fn(params, batch) -> (loss, {"ce", "aux"})."""
    def loss_fn(params, batch):
        with bound(model, params):
            return _loss(model, _on_device(batch, model.device), aux_coef)
    return loss_fn


def make_grad_fn(model, aux_coef: float = 1e-2):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: grad_fn(params,
    batch) -> ((loss, parts), grads), grads a dict like ``params``,
    everything detached."""
    def grad_fn(params, batch):
        names = list(params)
        with bound(model, params):
            loss, parts = _loss(model, _on_device(batch, model.device),
                                aux_coef)
            grads = torch.autograd.grad(loss, [params[k] for k in names],
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
                grads)
    return grad_fn


def _split_batch(batch: Dict, n: int):
    """(B, ...) -> n batches of (B // n, ...)."""
    for k, v in batch.items():
        if v is not None and v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
    rows = {k: v.shape[0] // n for k, v in batch.items() if v is not None}
    return [{k: v[i * rows[k]:(i + 1) * rows[k]] for k, v in batch.items()
             if v is not None} for i in range(n)]


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    aux_coef: float = 1e-2,
                    lr_schedule: Optional[Callable] = None):
    grad_fn = make_grad_fn(model, aux_coef)

    def train_step(params, opt_state: OptState, batch):
        if microbatches <= 1:
            (loss, parts), grads = grad_fn(params, batch)
        else:
            inv = 1.0 / microbatches
            grads = loss = parts = None
            for one in _split_batch(batch, microbatches):
                (l, p), g = grad_fn(params, one)
                if grads is None:
                    grads = {k: x.float() for k, x in g.items()}
                    loss, parts = l, dict(p)
                else:
                    for k, x in g.items():
                        grads[k] += x
                    loss = loss + l
                    parts = {k: parts[k] + p[k] for k in parts}
                del g
            for x in grads.values():
                x.mul_(inv)
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}
        lr_scale = (lr_schedule(opt_state.step) if lr_schedule is not None
                    else 1.0)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state, lr_scale)
        metrics = {"loss": loss, **parts, **om,
                   "step": opt_state.step.float()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch, pad_to: Optional[int] = None):
        with bound(model, params):
            return model.prefill(**_model_inputs(batch), pad_to=pad_to)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, token, caches, cur_index):
        with bound(model, params):
            return model.decode_step(token, caches, cur_index)
    return decode_step
