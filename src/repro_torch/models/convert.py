"""Load the JAX package's LM weights into the port's ``Model``.

The JAX package keeps a stack's layers as leaves with a leading repeat
axis, ``params["stack{i}"]["b{j}"][...]`` of shape ``(n_rep, ...)``, in
``stack_layout`` order, and an encoder-decoder's encoder likewise as
``params["enc_stack"]["b0"][...]``; the port keeps one module a
superblock, ``stacks.{i}.{r}.b{j}....`` and ``enc_stack.{r}.b0....``.
Every other leaf (``embed``, ``head``, ``final_norm``, ``enc_norm``)
keeps its name, and within a layer the names are JAX's (``moe.router``,
``xattn.wq``, ``ln_x``, ...).  :func:`load_jax_params` unstacks each
leaf along the repeat axis and copies it in.  It takes plain numpy (a
nested dict, ``jax.tree.map(np.asarray, params)``), so this module needs
no JAX; only the tests call it with JAX's weights.
:func:`stack_superblocks` and :func:`unstack_superblocks` move a dict of
tensors keyed by the port's names to JAX's leaves (``stack{i}.b{j}....``
and ``enc_stack.b0....`` with the repeat axis in front) and back, for
code that must see JAX's leaves (top-k selection per leaf).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .transformer import Model

__all__ = ["load_jax_params", "from_jax_params", "port_state",
           "stack_superblocks", "unstack_superblocks"]


def _port_prefix(head: str):
    """The port's name prefix of a JAX top-level key holding stacked
    superblocks (``stack{i}`` -> ``stacks.{i}``, ``enc_stack`` ->
    ``enc_stack``), or None for a plain leaf."""
    if head == "enc_stack":
        return "enc_stack"
    if head.startswith("stack") and head[5:].isdigit():
        return f"stacks.{head[5:]}"
    return None


def _flatten(node, prefix: Tuple[str, ...] = ()):
    for key, value in node.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def port_state(params) -> Dict[str, np.ndarray]:
    """The JAX params pytree as the port's parameter names -> arrays,
    each stacked leaf split into its superblocks."""
    state = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":       # numpy has no bf16 of its own
            arr = arr.astype(np.float32)
        prefix = _port_prefix(path[0])
        if prefix is not None:
            for r in range(arr.shape[0]):
                state[".".join((prefix, str(r)) + path[1:])] = arr[r]
        else:
            state[".".join(path)] = arr
    return state


def load_jax_params(model: Model, params) -> Model:
    """Copy the JAX package's ``params`` into ``model`` (in place, cast
    to each parameter's type); every parameter must be matched by one
    leaf of the same shape, and every leaf used."""
    state = port_state(params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameters without a JAX leaf: {missing}; JAX "
                       f"leaves without a parameter: {extra}")
    with torch.no_grad():
        for name, param in own.items():
            src = torch.from_numpy(np.array(state[name], copy=True))
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{name}: JAX leaf {tuple(src.shape)}, "
                                 f"parameter {tuple(param.shape)}")
            param.copy_(src.to(param.dtype))
    return model


def from_jax_params(cfg, params, device=None) -> Model:
    """A ``Model`` of ``cfg`` on ``device`` holding the JAX weights."""
    return load_jax_params(Model(cfg, device=device), params)


def stack_superblocks(tree: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``stacks.{i}.{r}.{rest}`` leaves stacked over r into
    ``stack{i}.{rest}``, ``enc_stack.{r}.{rest}`` into
    ``enc_stack.{rest}`` (JAX's leaves); other leaves as they are."""
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, t in tree.items():
        parts = name.split(".")
        if parts[0] == "stacks":
            key = ".".join([f"stack{parts[1]}"] + parts[3:])
            groups.setdefault(key, {})[int(parts[2])] = t
        elif parts[0] == "enc_stack":
            key = ".".join(["enc_stack"] + parts[2:])
            groups.setdefault(key, {})[int(parts[1])] = t
        else:
            out[name] = t
    for key, reps in groups.items():
        out[key] = torch.stack([reps[r] for r in range(len(reps))])
    return out


def unstack_superblocks(tree: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_superblocks` (views of its leaves)."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in tree.items():
        head, _, rest = name.partition(".")
        prefix = _port_prefix(head)
        if prefix is not None:
            for r in range(t.shape[0]):
                out[f"{prefix}.{r}.{rest}"] = t[r]
        else:
            out[name] = t
    return out

