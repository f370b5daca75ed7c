"""Logical-axis sharding policy (MaxText-style axis rules) over DTensor.

The port of the JAX package's ``sharding/policy.py``.  Every parameter
carries a tuple of logical axis names (``Parameter.logical_axes``, set
where the model creates it; ``Model.param_axes()`` collects them).  A
*policy* maps logical names to mesh axes; ``build_specs`` turns
(shapes, axes, policy, mesh) into specs with two safety rules applied
left to right per leaf:

  * divisibility — a mesh axis is assigned only if it divides the dim
    (this is what routes grok-1's 8 experts to d_ff TP while qwen3-moe's
    128 experts get true expert parallelism, with no per-arch code);
  * uniqueness  — a mesh axis is used at most once per leaf.

Policies:
  * ``tp``      — tensor parallelism on "model"; params replicated over
    the data axes (small models);
  * ``fsdp``    — tp + remaining dims sharded over ("pod", "data");
  * ``serve2d`` — weight matrices over (data x model) jointly;
  * optimizer states always use the fsdp rules (ZeRO-1).

A *spec* is a tuple with one entry a tensor dimension, as JAX's
``PartitionSpec``: None (replicated), a mesh-axis name, or a tuple of
names (the dimension split over several mesh axes, the first one
major); a one-name tuple reads as the name, as ``PartitionSpec`` has
it.  A *mesh* is a ``torch.distributed.DeviceMesh`` with named
dimensions, or, for the functions that only read its shape, a mapping
``{axis name: size}`` in mesh order (the JAX package's tests use an
``AbstractMesh`` the same way).  :func:`placements` turns a spec into
DTensor placements; a joint entry becomes one ``Shard(d)`` on each of
its mesh dimensions, which DTensor splits in mesh-dimension order —
data-major, as JAX splits a joint axis.

``use_mesh(mesh)`` stands in for JAX's ``with mesh:``: under it,
``constrain`` and ``reshard_tree`` redistribute DTensors; without an
ambient mesh both are no-ops, so the smoke runs stay mesh-free.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["rules_for", "build_specs", "param_policy", "batch_spec",
           "cache_specs", "named", "distribute", "placements",
           "use_mesh", "current_mesh", "constrain", "reshard_tree",
           "mesh_shape", "FSDP_THRESHOLD"]

# parameters above this count get fully-sharded (fsdp) treatment
FSDP_THRESHOLD = 15e9

Spec = Tuple[Any, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of a
    mapping that already is one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the policy needs a mesh with named dimensions")
    return dict(zip(names, mesh.shape))


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def rules_for(policy: str, mesh) -> Dict[str, Any]:
    dp = _dp_axes(mesh)
    model: Any = "model"
    if policy == "serve2d":
        # weight matrices over (data x model) jointly and resident: no
        # per-layer parameter all-gather on the decode path
        model = tuple(dp) + ("model",)
    return {
        "vocab": model,
        "q_proj": model,
        "kv_proj": model,
        "mlp": model,
        "expert": model,
        "lru": model,
        "ssm_in": model,
        "ssm_inner": model,
        "ssm_conv": model,
        "embed": dp if policy == "fsdp" else None,
        "head_dim": None,
        "ssm_heads": None,
        "layers": None,       # the JAX scan axis stays unsharded
    }


def param_policy(cfg) -> str:
    return "fsdp" if cfg.param_count() > FSDP_THRESHOLD else "tp"


def _axis_size(mesh, ax) -> int:
    shape = mesh_shape(mesh)
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return int(np.prod([shape[a] for a in ax]))
    return shape[ax]


def _entry(ax):
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple is
    the name."""
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _spec_for_leaf(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                   rules: Dict[str, Any], mesh) -> Spec:
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        ax = rules.get(name) if name is not None else None
        flat = tuple(ax) if isinstance(ax, tuple) else ((ax,) if ax else ())
        if (ax is not None and not (set(flat) & used)
                and dim % _axis_size(mesh, ax) == 0 and dim > 0):
            out.append(_entry(ax))
            used.update(flat)
        else:
            out.append(None)
    return tuple(out)


def build_specs(shapes: Mapping[str, Any], axes: Mapping[str, tuple],
                policy: str, mesh) -> Dict[str, Spec]:
    """shapes (name -> a tensor or a shape) and axes (name -> logical
    names) -> name -> spec."""
    rules = rules_for(policy, mesh)
    return {name: _spec_for_leaf(tuple(getattr(s, "shape", s)), axes[name],
                                 rules, mesh)
            for name, s in shapes.items()}


def batch_spec(mesh, ndim: int, batch_divisible: bool = True) -> Spec:
    """Batch-leading activations: the batch over (pod, data) when the
    global batch divides; everything else replicated."""
    dp = _dp_axes(mesh)
    lead = dp if (batch_divisible and dp) else None
    return (_entry(lead),) + (None,) * (ndim - 1)


def cache_specs(cfg, mesh, batch: int, seq: int):
    """Spec factory for serving caches.

    attention (B, S, KV, D): batch over dp when divisible; KV heads over
    "model" when divisible, else the sequence axis takes "model"
    (context sharding) — the policy that keeps 32k caches inside HBM
    for GQA archs whose few KV heads do not divide the model axis."""
    dp = _dp_axes(mesh)
    dp_ok = batch % _axis_size(mesh, dp) == 0 if dp else False
    b_ax = _entry(dp) if dp_ok else None
    m = mesh_shape(mesh)["model"]

    def attn(kv_heads: int, cache_len: int) -> Spec:
        if kv_heads % m == 0:
            return (b_ax, None, "model", None)
        if cache_len % m == 0:
            return (b_ax, "model", None, None)
        return (b_ax, None, None, None)

    return dict(
        attn=attn,
        conv=lambda c: (b_ax, None, "model" if c % m == 0 else None),
        lru_h=lambda w: (b_ax, "model" if w % m == 0 else None),
        ssm_h=lambda h: (b_ax, "model" if h % m == 0 else None, None, None),
        batch_axis=b_ax,
    )


# ------------------------------------------------------------------ #
# specs -> DTensor placements
# ------------------------------------------------------------------ #
def placements(spec: Spec, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` on each mesh dimension that tensor dimension ``d``'s
    entry names (of more than one rank), ``Replicate()`` on the others.
    A joint entry must name its axes in mesh order (DTensor splits a
    dimension over several mesh dimensions in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    shape = mesh_shape(mesh)
    names = list(shape)
    out: List = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        flat = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"joint axis {flat} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            # a mesh axis of one rank splits nothing: whole there
            if shape[names[i]] > 1:
                out[i] = Shard(d)
    return out


def named(mesh, spec_tree: Mapping[str, Spec]) -> Dict[str, List]:
    """name -> placements (JAX's ``NamedSharding`` per leaf)."""
    return {k: placements(s, mesh) for k, s in spec_tree.items()}


def distribute(tensors: Mapping[str, torch.Tensor],
               specs: Mapping[str, Spec], mesh,
               requires_grad: Optional[bool] = None
               ) -> Dict[str, torch.Tensor]:
    """Each tensor as a DTensor placed by its spec (every rank passes
    the same full tensor; on ``meta`` nothing moves, and on a one-rank
    mesh the tensor itself is wrapped).  Parameters come
    back as leaf tensors that require grad as the originals did, or as
    ``requires_grad`` says."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    out = {}
    for name, t in tensors.items():
        rg = t.requires_grad if requires_grad is None else requires_grad
        pl = placements(specs[name], mesh)
        if mesh.size() == 1:
            # one rank holds every shard: wrap the tensor, no copy
            d = DTensor.from_local(t.detach(), mesh, pl, run_check=False)
        else:
            d = distribute_tensor(t.detach(), mesh, pl)
        out[name] = d.requires_grad_(rg)
    return out


# ------------------------------------------------------------------ #
# the ambient mesh (JAX's ``with mesh:``)
# ------------------------------------------------------------------ #
_MESHES: List[Any] = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Inside the block, ``constrain`` and ``reshard_tree`` act on
    ``mesh``."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost :func:`use_mesh` mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def reshard_tree(tree: Mapping[str, torch.Tensor],
                 axes: Mapping[str, tuple], policy: str = "tp"
                 ) -> Dict[str, torch.Tensor]:
    """Each DTensor leaf of ``tree`` redistributed to ``policy``'s rules
    under the ambient mesh (no-op without one).  Used to hoist FSDP->TP
    parameter all-gathers to once a step: the forward/backward consume
    the TP view while the optimizer state stays fully sharded; the
    redistribution is differentiable, so the gradients reach the FSDP
    leaves."""
    mesh = current_mesh()
    if mesh is None:
        return dict(tree)
    specs = build_specs(tree, axes, policy, mesh)
    return {k: (v.redistribute(mesh, placements(specs[k], mesh))
                if _is_dtensor(v) else v) for k, v in tree.items()}


def constrain(x, *spec):
    """Best-effort sharding constraint: applied only to a DTensor under
    an ambient mesh with the named axes, and only on dims they divide.

    Model code calls this at sharding-critical intermediates (the MoE
    dispatch buffers, the sequence-parallel residual) so they stay
    distributed as the JAX partitioner keeps them; on meshless runs it
    is a no-op."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    shape = mesh_shape(mesh)
    out = []
    for dim, ax in zip(x.shape, spec):
        flat = () if ax is None else ((ax,) if isinstance(ax, str)
                                      else tuple(ax))
        flat = tuple(a for a in flat if a in shape)   # drop absent axes
        if flat:
            size = int(np.prod([shape[a] for a in flat]))
            if dim % size == 0 and dim > 0:
                out.append(flat[0] if len(flat) == 1 else flat)
                continue
        out.append(None)
    if all(o is None for o in out):
        return x
    out += [None] * (x.dim() - len(out))
    return x.redistribute(mesh, placements(tuple(out), mesh))
