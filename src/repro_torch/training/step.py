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

Under a mesh the parameters, moments and batch are DTensors
(``repro_torch.launch.dryrun.build_cell`` places them).  With
``param_axes`` and ``compute_policy`` (e.g. ``"tp"``) the step reshards
the parameters to that policy's layout once at entry
(``sharding.policy.reshard_tree``), so an FSDP parameter is gathered
once a step rather than once a microbatch, and the gradients are taken
at that view.  Before the update each gradient is redistributed to its
moment's placement (ZeRO-1: the moments follow the fsdp rules), which
for a gradient of the gathered view is the reduce-scatter the backward
of the gather would be.
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
    labels (B, S) int.  DTensor logits take the vocab-parallel route
    (:func:`_vocab_parallel_nll`), rows and vocabulary shards local."""
    from ..kernels.common import is_dtensor
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def _vocab_parallel_nll(logits, labels):
    """lse - ll of DTensor logits (B, S, V), each rank's rows and
    vocabulary shard kept local (Megatron's vocab-parallel CE): the row
    max as a max over the vocabulary's shards, the sum of exp(logit -
    max) and the label's logit (from the shard that holds it) as sums
    over them.  Gathering the logits instead would hold B S V floats a
    device."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..models.layers import vocab_offset

    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    on = [i for i, p in enumerate(logits.placements) if p.is_shard(vdim)]
    start, _ = vocab_offset(mesh, on, logits.shape[-1])
    rows = [Replicate() if i in on else p
            for i, p in enumerate(logits.placements)]

    def over(op):
        return [Partial(op) if i in on else p for i, p in enumerate(rows)]

    m = local_map(lambda lg: lg.detach().amax(dim=-1),
                  out_placements=over("max"),
                  in_placements=(list(logits.placements),),
                  device_mesh=mesh)(logits)
    m = m.redistribute(mesh, rows)

    def local(lg, lb, mx):
        idx = lb.long() - start
        mine = (idx >= 0) & (idx < lg.shape[-1])
        ll = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return (torch.exp(lg - mx[..., None]).sum(dim=-1),
                torch.where(mine, ll[..., 0], 0.0))

    sums, ll = local_map(local, out_placements=(over("sum"), over("sum")),
                         in_placements=(list(logits.placements), rows,
                                        rows),
                         redistribute_inputs=True, device_mesh=mesh)(
        logits, labels, m)
    sums = sums.redistribute(mesh, rows)
    ll = ll.redistribute(mesh, rows)
    return m + torch.log(sums) - ll


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
    """(B, ...) -> n batches of (B // n, ...).  A DTensor batch is split
    rank by rank: microbatch i is each rank's i-th slice of its own
    rows, so no row moves between ranks (the microbatches' gradients
    are summed, so which rows share one does not matter)."""
    from ..kernels.common import is_dtensor
    if any(is_dtensor(v) for v in batch.values() if v is not None):
        return _split_local(batch, n)
    for k, v in batch.items():
        if v is not None and v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
    rows = {k: v.shape[0] // n for k, v in batch.items() if v is not None}
    return [{k: v[i * rows[k]:(i + 1) * rows[k]] for k, v in batch.items()
             if v is not None} for i in range(n)]


def _to_moments(grads, moments):
    """Each DTensor gradient redistributed to its moment's placement."""
    from ..kernels.common import is_dtensor
    out = {}
    for k, g in grads.items():
        m = moments[k]
        if is_dtensor(g) and is_dtensor(m) and g.placements != m.placements:
            g = g.redistribute(m.device_mesh, m.placements)
        out[k] = g
    return out


def _split_local(batch: Dict, n: int):
    from torch.distributed.tensor import DTensor
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        if v is None:
            continue
        local = v.to_local()
        if local.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {local.shape[0]} rows a "
                             f"rank, not a multiple of {n} microbatches")
        shape = (v.shape[0] // n,) + tuple(v.shape[1:])
        for i, part in enumerate(local.chunk(n)):
            out[i][k] = DTensor.from_local(part, v.device_mesh, v.placements,
                                           run_check=False, shape=shape,
                                           stride=torch.empty(
                                               shape, device="meta").stride())
    return out


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    aux_coef: float = 1e-2,
                    lr_schedule: Optional[Callable] = None,
                    param_axes=None, compute_policy: Optional[str] = None):
    """``param_axes`` + ``compute_policy``: reshard the parameters to
    that policy once at step entry (see the module's docstring)."""
    grad_fn = make_grad_fn(model, aux_coef)

    def train_step(params, opt_state: OptState, batch):
        live = params
        if param_axes is not None and compute_policy is not None:
            from ..sharding.policy import reshard_tree
            with torch.no_grad():
                view = reshard_tree(params, param_axes, compute_policy)
            live = {k: v.detach().requires_grad_(params[k].requires_grad)
                    for k, v in view.items()}
        if microbatches <= 1:
            (loss, parts), grads = grad_fn(live, batch)
        else:
            inv = 1.0 / microbatches
            grads = loss = parts = None
            for one in _split_batch(batch, microbatches):
                (l, p), g = grad_fn(live, one)
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
        grads = _to_moments(grads, opt_state.m)
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
