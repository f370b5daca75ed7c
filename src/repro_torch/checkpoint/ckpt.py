"""Sharded checkpointing with atomic commit, on the JAX package's format.

The port of the JAX package's ``checkpoint/ckpt.py``.  Layout:

    <dir>/step_<n>/
        manifest.json   — leaf paths, shapes, dtypes, shard of each, meta
        shard_<k>.npz   — the leaves, split round-robin largest-first

  * atomic    — written to ``.tmp-…`` then ``os.replace``'d, so a save
    that dies never corrupts the latest checkpoint;
  * resumable — ``latest_step`` sees committed steps only;
  * retention — ``keep`` bounds the steps on disk;
  * self-describing — the manifest carries the caller's metadata (data
    step, gossip round, pod id) for an exact resume.

A tree is nested dicts whose leaves are tensors, numpy arrays or
numbers; ``None`` is an empty subtree, as in JAX.  Leaves
are flattened in JAX's order (dict keys sorted) and named by their path
in JAX's ``keystr`` form, so the port's state ``{"params": {name: tensor},
"opt": ...}`` has leaves like ``['params']['stacks.0.1.b0.ln1']``.
bfloat16 tensors (numpy has no such type) are stored as their uint16
bits under the dtype name ``bfloat16``.

:func:`load_jax_checkpoint` reads a checkpoint the JAX package wrote
(leaves ``['params']['stack0']['b0']...`` with the repeat axis in front)
into a port model through ``models.convert``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "available_steps",
           "load_jax_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(_flatten(tree[k], f"{prefix}[{k!r}]"))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if not isinstance(like, dict):
        return next(leaves)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> np.ndarray | torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def save(directory: str, step: int, tree, *, meta: Optional[Dict] = None,
         shards: int = 4, keep: int = 3) -> str:
    """Write a checkpoint; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".tmp-step_{step}-", dir=directory)
    try:
        leaves = [(path, *_to_numpy(leaf)) for path, leaf in _flatten(tree)]
        manifest = {"step": step, "meta": meta or {}, "leaves": [],
                    "format": 1, "shards": shards}
        # round-robin largest-first for balanced shard files
        order = sorted(range(len(leaves)), key=lambda i: -leaves[i][1].nbytes)
        shard_of = {}
        sizes = [0] * shards
        for i in order:
            k = int(np.argmin(sizes))
            shard_of[i] = k
            sizes[k] += leaves[i][1].nbytes
        per_shard: List[Dict[str, np.ndarray]] = [{} for _ in range(shards)]
        for i, (path, arr, dtype) in enumerate(leaves):
            manifest["leaves"].append(
                {"path": path, "shape": list(arr.shape), "dtype": dtype,
                 "shard": shard_of[i]})
            per_shard[shard_of[i]][f"leaf_{i}"] = arr
        for k in range(shards):
            np.savez(os.path.join(tmp, f"shard_{k}.npz"), **per_shard[k])
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int) -> None:
    steps = available_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _read(directory: str, step: int):
    base = os.path.join(directory, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    files = {}
    flat = []
    try:
        for i, ent in enumerate(manifest["leaves"]):
            k = ent["shard"]
            if k not in files:
                files[k] = np.load(os.path.join(base, f"shard_{k}.npz"))
            arr = files[k][f"leaf_{i}"]
            if list(arr.shape) != ent["shape"]:
                raise ValueError(f"{ent['path']}: stored {arr.shape}, "
                                 f"manifest {ent['shape']}")
            flat.append(_from_numpy(arr, ent["dtype"]))
    finally:
        for f in files.values():
            f.close()
    return manifest, flat


def restore(directory: str, step: int, like=None) -> Tuple[Any, Dict]:
    """Load a checkpoint; returns (tree, meta).

    Without ``like`` the tree is ``{path: array}``.  With ``like`` (a tree
    of the same structure) the leaf count and every shape are checked
    against it, and the tree comes back in its structure, each leaf that
    ``like`` holds as a tensor as a tensor of that leaf's dtype and
    device."""
    manifest, flat = _read(directory, step)
    if like is None:
        return ({ent["path"]: a for ent, a in zip(manifest["leaves"], flat)},
                manifest["meta"])
    tmpl = _flatten(like)
    if len(tmpl) != len(flat):
        raise ValueError(f"leaf count mismatch: checkpoint {len(flat)} vs "
                         f"template {len(tmpl)}")
    out = []
    for (path, t), arr, ent in zip(tmpl, flat, manifest["leaves"]):
        shape = tuple(np.shape(t))
        if shape != tuple(arr.shape):
            raise ValueError(f"{ent['path']}: checkpoint {tuple(arr.shape)}"
                             f", template {path} {shape}")
        if isinstance(t, torch.Tensor):
            arr = torch.as_tensor(arr).to(device=t.device, dtype=t.dtype)
        out.append(arr)
    return _unflatten(like, iter(out)), manifest["meta"]


def load_jax_checkpoint(directory: str, step: int, model,
                        prefix: str = "['params']"):
    """Copy the parameters of a JAX-package checkpoint (the leaves under
    ``prefix``) into ``model``; returns the checkpoint's meta."""
    from ..models.convert import load_jax_params
    flat, meta = restore(directory, step)
    params: Dict = {}
    for path, arr in flat.items():
        if not path.startswith(prefix):
            continue
        keys = _KEY_RE.findall(path[len(prefix):])
        node = params
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = (arr.float().numpy()
                          if isinstance(arr, torch.Tensor) else arr)
    if not params:
        raise ValueError(f"no leaf under {prefix} in {directory}/step_{step}")
    load_jax_params(model, params)
    return meta
