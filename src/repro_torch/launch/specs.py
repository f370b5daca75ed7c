"""Abstract stand-ins and specs for every input of a dry-run cell.

The port of the JAX package's ``launch/specs.py``.  Where JAX builds
``ShapeDtypeStruct``s, the port builds ``meta`` tensors: the same
shapes and dtypes, and no memory behind them.  ``input_specs(cfg,
shape, mesh)`` returns (abstract inputs, specs) for the step function
the (arch x shape) cell runs: the train step for train shapes, prefill
or decode for serving shapes.  A spec is a tuple with one entry a
dimension (``repro_torch.sharding.policy``).

The port's parameters and caches keep one tensor a superblock, so the
specs of a stacked JAX leaf lose its leading entry (the "layers" axis,
never sharded) here; the parameter names are the port's
(``models/convert.py`` links them to JAX's leaves).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.transformer import Model, cache_seq_len, stack_layout
from ..sharding.policy import (batch_spec, build_specs, cache_specs,
                               mesh_shape, param_policy)
from ..training.optimizer import OptState

__all__ = ["input_specs", "shapes_and_axes", "abstract_opt_state",
           "make_batch", "make_serving_inputs", "param_specs", "opt_specs"]

META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """Abstract stand-ins for every model input of a cell, and their
    specs: train/prefill -> (batch dict, spec dict); decode ->
    ((token, caches, cur_index), specs)."""
    if shape.kind == "decode":
        return make_serving_inputs(cfg, shape, mesh)
    return make_batch(cfg, shape, mesh, with_labels=(shape.kind == "train"))


def shapes_and_axes(model_or_cfg, **model_kw):
    """(name -> meta parameter, name -> logical axes) of a ``Model`` (or
    of the ``Model`` of a config, built on ``meta``): no allocation."""
    model = model_or_cfg
    if not isinstance(model, Model):
        model = Model(model_or_cfg, device=META, **model_kw)
    return dict(model.named_parameters()), model.param_axes()


def abstract_opt_state(param_shapes: Dict[str, torch.Tensor],
                       master_weights: bool = False) -> OptState:
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device=META)
    return OptState(m={k: f32(p) for k, p in param_shapes.items()},
                    v={k: f32(p) for k, p in param_shapes.items()},
                    step=torch.empty((), dtype=torch.int32, device=META),
                    master=({k: f32(p) for k, p in param_shapes.items()}
                            if master_weights else None))


def param_specs(cfg, param_shapes, axes, mesh, policy: Optional[str] = None):
    return build_specs(param_shapes, axes, policy or param_policy(cfg), mesh)


def opt_specs(cfg, param_shapes, axes, mesh, master_weights: bool = False):
    """ZeRO-1: moments (and the f32 master copy) always use fsdp rules."""
    mspec = build_specs(param_shapes, axes, "fsdp", mesh)
    return OptState(m=mspec, v=mspec, step=(),
                    master=mspec if master_weights else None)


# ------------------------------------------------------------------ #
# batches (train / prefill)
# ------------------------------------------------------------------ #
def _dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in shape if a in ("pod", "data")]))


def make_batch(cfg: ArchConfig, shape: ShapeSpec, mesh,
               with_labels: bool = True):
    """(abstract batch dict, spec dict) for train/prefill inputs."""
    b, s = shape.global_batch, shape.seq_len
    cd = getattr(torch, cfg.compute_dtype)
    dp = batch_spec(mesh, 2, b % _dp_size(mesh) == 0)
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if cfg.frontend == "vision":
        # VLM stub: precomputed patch/text embeddings + 3-D M-RoPE positions
        batch["embeds"] = empty((b, s, cfg.d_model), cd)
        specs["embeds"] = (dp[0], None, None)
        batch["positions"] = empty((b, 3, s), torch.int32)
        specs["positions"] = (dp[0], None, None)
    else:
        batch["tokens"] = empty((b, s), torch.int32)
        specs["tokens"] = dp
    if cfg.is_encdec:
        batch["enc_embeds"] = empty((b, cfg.encoder_seq, cfg.d_model), cd)
        specs["enc_embeds"] = (dp[0], None, None)
    if with_labels:
        batch["labels"] = empty((b, s), torch.int32)
        specs["labels"] = dp
    return batch, specs


# ------------------------------------------------------------------ #
# serving caches (decode)
# ------------------------------------------------------------------ #
def _layer_cache(cfg, kind: str, b: int, s: int, dtype):
    def empty(shp, dt=dtype):
        return torch.empty(shp, dtype=dt, device=META)

    if kind == "attn":
        shp = (b, cache_seq_len(cfg, "attn", s), cfg.num_kv_heads,
               cfg.head_dim)
        return (empty(shp), empty(shp))
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return (empty((b, cfg.conv_width - 1, w)),
                empty((b, w), torch.float32))
    di, n = cfg.d_inner, cfg.ssm_state
    return (empty((b, cfg.conv_width - 1, di + 2 * n)),
            empty((b, cfg.ssm_heads, n, cfg.ssm_head_dim)))


def make_serving_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """(abstract (token, caches, cur_index), specs) for decode cells;
    caches and their specs in the model's layout (a list a stack of a
    list a superblock of ``{"b{i}": ..., "b{i}_x": ...}``)."""
    b, s = shape.global_batch, shape.seq_len
    cd = getattr(torch, cfg.compute_dtype)
    pol = cache_specs(cfg, mesh, b, s)
    caches, specs = [], []
    for spec in stack_layout(cfg):
        c_stack, s_stack = [], []
        for _ in range(spec.n_rep):
            c, sp = {}, {}
            for i, kind in enumerate(spec.pattern):
                c[f"b{i}"] = _layer_cache(cfg, kind, b, s, cd)
                sp[f"b{i}"] = _cache_spec(cfg, kind, pol, s)
                if cfg.is_encdec:
                    shp = (b, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
                    c[f"b{i}_x"] = (torch.empty(shp, dtype=cd, device=META),
                                    torch.empty(shp, dtype=cd, device=META))
                    xs = pol["attn"](cfg.num_kv_heads, cfg.encoder_seq)
                    sp[f"b{i}_x"] = (xs, xs)
            c_stack.append(c)
            s_stack.append(sp)
        caches.append(c_stack)
        specs.append(s_stack)
    token = torch.empty((b,), dtype=torch.int32, device=META)
    token_spec = (pol["batch_axis"],)
    cur = torch.empty((), dtype=torch.int32, device=META)
    return (token, caches, cur), (token_spec, specs, ())


def _cache_spec(cfg, kind: str, pol, s: int):
    if kind == "attn":
        sp = pol["attn"](cfg.num_kv_heads, cache_seq_len(cfg, "attn", s))
        return (sp, sp)
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return (pol["conv"](w), pol["lru_h"](w))
    return (pol["conv"](cfg.d_inner + 2 * cfg.ssm_state),
            pol["ssm_h"](cfg.ssm_heads))
