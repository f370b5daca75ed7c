"""Load the JAX package's LM weights into the port's ``Model``.

The JAX package keeps a stack's layers as leaves with a leading repeat
axis, ``params["stack{i}"]["b{j}"][...]`` of shape ``(n_rep, ...)``, in
``stack_layout`` order; the port keeps one module a superblock,
``stacks.{i}.{r}.b{j}....``.  :func:`load_jax_params` unstacks each leaf
along that axis and copies it in.  It takes plain numpy (a nested dict,
``jax.tree.map(np.asarray, params)``), so this module needs no JAX; only
the tests call it with JAX's weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .transformer import Model

__all__ = ["load_jax_params", "from_jax_params", "port_state"]


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
        if path[0].startswith("stack"):
            for r in range(arr.shape[0]):
                name = ".".join(("stacks", path[0][len("stack"):], str(r))
                                + path[1:])
                state[name] = arr[r]
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
