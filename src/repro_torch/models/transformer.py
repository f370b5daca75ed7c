"""Decoder-LM stack of the dense, SSM and hybrid families.

The port of the JAX package's ``models/transformer.py``.  Depth is
organised in *superblocks*, as there: the block pattern (e.g.
RecurrentGemma's (rec, rec, attn)) repeated ``n_rep`` times, then a
partial tail stack (``stack_layout``).  Each stack is an
``nn.ModuleList`` of its superblocks, each superblock an
``nn.ModuleDict`` of its layers ``b0``, ``b1``, ...; the JAX package's
``lax.scan`` over the repeat axis is a Python loop here.

Three entry points share the layer code:
  * ``forward``      — full-sequence logits (training);
  * ``prefill``      — the prompt's last logits and the serving caches;
  * ``decode_step``  — one token against the caches.

Caches are a list (one entry a stack) of lists (one a superblock) of
dicts ``{"b0": cache, ...}``; a layer's cache has the batch on axis 0:
(k, v) of (B, S, KV, D) for attention, (conv_state, h) for RG-LRU,
(conv_state, ssm_state) for Mamba-2.

The recurrent layers' prefill always goes through the kernel wrappers
of ``repro_torch.kernels``: the hand-written kernel for CUDA tensors,
the plain version for CPU tensors.  There is no ``use_pallas`` switch:
the JAX package needs one to keep its TPU kernels out of CPU runs,
where the wrappers here choose by device already, and a switch could
only keep the kernel off the card's path.

Training differentiates ``forward``.  ``remat`` recomputes each
superblock's activations in the backward, as the JAX package's
``jax.checkpoint`` over the scan body does: ``"full"`` keeps nothing
(``nothing_saveable``), ``"dots"`` keeps the matrix products' outputs
(``dots_saveable``, through selective checkpointing).  MoE,
encoder-decoder and M-RoPE archs, and the knobs ``unroll`` and
``seq_shard``, are not ported yet (the port's superblock loop is a
Python loop already).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint as ckpt

from ..backend import resolve_device
from .layers import attention, decode_attention, init_dense, mlp, rms_norm
from .rglru import RGLRU, rglru_decode_step, rglru_forward
from .ssm import SSM, _param, ssd_forward, ssm_decode_step

__all__ = ["Model", "build_model", "StackSpec", "stack_layout",
           "cache_seq_len", "REMATS"]

_LATER = ("waits for a later slice of the port (ROADMAP.md, queue 1, "
          "item 13)")
#: the ``remat`` modes of ``Model``
REMATS = ("none", "dots", "full")


# ------------------------------------------------------------------ #
# layers
# ------------------------------------------------------------------ #
def _has_mlp(cfg, kind: str) -> bool:
    return cfg.d_ff > 0 and kind != "ssm"


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device, gen):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.attn_q_dim, cfg.attn_kv_dim
        self.wq = _param(init_dense(gen, (d, qd), dtype, device))
        self.wk = _param(init_dense(gen, (d, kvd), dtype, device))
        self.wv = _param(init_dense(gen, (d, kvd), dtype, device))
        self.wo = _param(init_dense(gen, (qd, d), dtype, device))
        if cfg.qk_norm:
            self.q_norm = _param(torch.ones(cfg.head_dim, dtype=dtype,
                                            device=device))
            self.k_norm = _param(torch.ones(cfg.head_dim, dtype=dtype,
                                            device=device))


class MLP(nn.Module):
    def __init__(self, d, d_ff, dtype, device, gen):
        super().__init__()
        self.w_gate = _param(init_dense(gen, (d, d_ff), dtype, device))
        self.w_up = _param(init_dense(gen, (d, d_ff), dtype, device))
        self.w_down = _param(init_dense(gen, (d_ff, d), dtype, device))


class Layer(nn.Module):
    """One block: pre-norm, the mixer (``attn``, ``rec`` or ``ssm``),
    and for every kind but ssm a pre-norm SwiGLU MLP."""

    def __init__(self, cfg, kind: str, dtype, device, gen):
        super().__init__()
        self.kind = kind
        self.ln1 = _param(torch.ones(cfg.d_model, dtype=dtype, device=device))
        if kind == "attn":
            self.attn = Attention(cfg, dtype, device, gen)
        elif kind == "rec":
            self.rec = RGLRU(cfg, dtype, device, gen)
        else:
            self.ssm = SSM(cfg, dtype, device, gen)
        if _has_mlp(cfg, kind):
            self.ln2 = _param(torch.ones(cfg.d_model, dtype=dtype,
                                         device=device))
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, gen)


def apply_layer(layer: Layer, cfg, x, positions, mode: str, cache=None,
                cur_index=None):
    """Returns (x, new_cache)."""
    kind = layer.kind
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    if kind == "attn":
        if mode == "decode":
            out, ck, cv = decode_attention(layer.attn, cfg, h, cache[0],
                                           cache[1], cur_index,
                                           window=cfg.window)
            new_cache = (ck, cv)
        else:
            mk = "local" if cfg.window else "causal"
            out, new_cache = attention(layer.attn, cfg, h, positions, mk)
    elif kind == "rec":
        if mode == "decode":
            out, new_cache = rglru_decode_step(layer.rec, cfg, h, cache)
        else:
            out, new_cache = rglru_forward(layer.rec, cfg, h)
    else:
        if mode == "decode":
            out, new_cache = ssm_decode_step(layer.ssm, cfg, h, cache)
        else:
            out, new_cache = ssd_forward(layer.ssm, cfg, h)
    x = x + out
    if _has_mlp(cfg, kind):
        x = x + mlp(layer.mlp, rms_norm(x, layer.ln2, cfg.norm_eps))
    return x, new_cache


def cache_seq_len(cfg, kind: str, seq: int) -> int:
    """Attention caches of windowed layers need only ``window`` slots."""
    if kind == "attn" and cfg.window:
        return min(seq, cfg.window)
    return seq


# ------------------------------------------------------------------ #
# superblock stacks
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class StackSpec:
    pattern: Tuple[str, ...]   # block kinds within one superblock
    n_rep: int                 # superblocks in the stack


def stack_layout(cfg) -> List[StackSpec]:
    kinds = cfg.layer_kinds()
    pat = cfg.block_pattern or (kinds[0],)
    plen = len(pat)
    n_full, rem = divmod(len(kinds), plen)
    out = []
    if n_full:
        out.append(StackSpec(tuple(pat), n_full))
    if rem:
        out.append(StackSpec(tuple(pat[:rem]), 1))
    return out


def _grow(t: torch.Tensor, target: int) -> torch.Tensor:
    """A prompt's (B, S', KV, D) k or v as a serving cache of ``target``
    slots: zero-padded, or — for a windowed layer's circular buffer when
    the prompt is longer — its tail rolled so that position p sits in
    slot p % target."""
    src = t.shape[1]
    if src > target:
        tail = t[:, -target:]
        r = src % target
        return torch.roll(tail, r, dims=1) if r else tail
    if src == target:
        return t
    pad = t.new_zeros((t.shape[0], target - src) + tuple(t.shape[2:]))
    return torch.cat([t, pad], dim=1)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_saveable``: keep the outputs of matrix products, recompute
    everything else."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(block, cfg, x, positions):
    for layer in block.values():
        x, _ = apply_layer(layer, cfg, x, positions, "train")
    return x


def _remat_block(remat: str, block, cfg, x, positions):
    """One superblock of the training forward, its activations
    recomputed in the backward (``remat`` "full" or "dots")."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(_run_block, block, cfg, x, positions,
                           use_reentrant=False, **kw)


# ------------------------------------------------------------------ #
# full model
# ------------------------------------------------------------------ #
class Model(nn.Module):
    """The LM of one ``ArchConfig``, its weights drawn at random.

    ``device`` is resolved by ``repro_torch.backend.resolve_device`` (the
    card unless ``"cpu"`` is asked for); ``dtype`` is the parameters'
    type (default ``cfg.param_dtype``); the weights come from
    ``generator`` (a ``torch.Generator`` on ``device``) or from one seeded
    with ``seed``.  They cannot equal the JAX package's ``Model.init``
    draws; ``repro_torch.models.convert`` loads those.  The parameters
    require grad (``repro_torch.training`` trains them); ``remat`` is one
    of :data:`REMATS`.  Activations run in ``cfg.compute_dtype``."""

    def __init__(self, cfg, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 remat: str = "none"):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        self.remat = remat
        for flag, what in ((cfg.is_moe, "MoE"),
                           (cfg.is_encdec, "the encoder-decoder"),
                           (cfg.mrope, "M-RoPE")):
            if flag:
                raise NotImplementedError(f"{cfg.name}: {what} {_LATER}")
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.param_dtype)
        gen = generator or torch.Generator(device=dev).manual_seed(seed)
        self.embed = _param((torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen,
            dtype=torch.float32, device=dev) * 0.02).to(dtype))
        self.stacks = nn.ModuleList([
            nn.ModuleList([
                nn.ModuleDict({f"b{i}": Layer(cfg, kind, dtype, dev, gen)
                               for i, kind in enumerate(spec.pattern)})
                for _ in range(spec.n_rep)])
            for spec in stack_layout(cfg)])
        self.final_norm = _param(torch.ones(cfg.d_model, dtype=dtype,
                                            device=dev))
        if not cfg.tie_embeddings:
            self.head = _param(init_dense(gen, (cfg.d_model, cfg.vocab_size),
                                          dtype, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # ---------------- helpers ----------------------------------------- #
    def _embed(self, tokens):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return self.embed[tokens].to(self.compute_dtype)

    def _logits(self, x):
        head = self.embed.t() if self.cfg.tie_embeddings else self.head
        return (x @ head.to(x.dtype)).float()

    def _run(self, x, positions, mode: str, caches=None, cur_index=None):
        """Every layer in order; returns (x, caches) with the caches of
        the prefill or decode mode (None in "train")."""
        if mode == "train":
            for stack in self.stacks:
                for block in stack:
                    if self.remat != "none" and torch.is_grad_enabled():
                        x = _remat_block(self.remat, block, self.cfg, x,
                                         positions)
                    else:
                        x = _run_block(block, self.cfg, x, positions)
            return x, None
        out = []
        for s, stack in enumerate(self.stacks):
            stack_out = []
            for r, block in enumerate(stack):
                new_c = {}
                for name, layer in block.items():
                    c_in = caches[s][r][name] if caches is not None else None
                    x, c = apply_layer(layer, self.cfg, x, positions, mode,
                                       cache=c_in, cur_index=cur_index)
                    new_c[name] = c
                stack_out.append(new_c)
            out.append(stack_out)
        return x, out

    def _positions(self, x):
        b, s, _ = x.shape
        return torch.arange(s, device=x.device, dtype=torch.int32)[
            None].expand(b, s)

    # ---------------- entry points ------------------------------------ #
    def forward(self, tokens):
        """Full-sequence logits (B, S, V), f32.  ``tokens`` (B, S)."""
        x = self._embed(tokens)
        x, _ = self._run(x, self._positions(x), "train")
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, tokens, pad_to: Optional[int] = None):
        """Run the prompt (B, S); return (last-token logits (B, V) f32,
        serving caches).  Attention caches hold ``pad_to`` slots (default
        S), or ``min(pad_to, window)`` for windowed layers."""
        x = self._embed(tokens)
        s = x.shape[1]
        x, caches = self._run(x, self._positions(x), "prefill")
        # only the last position's logits: the (B, S, V) head is waste
        x = rms_norm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        logits = self._logits(x)[:, -1]
        target = cache_seq_len(self.cfg, "attn", pad_to or s)
        for stack, stack_caches in zip(self.stacks, caches):
            for block, block_caches in zip(stack, stack_caches):
                for name, layer in block.items():
                    if layer.kind == "attn":
                        k, v = block_caches[name]
                        block_caches[name] = (_grow(k, target),
                                              _grow(v, target))
        return logits, caches

    @torch.no_grad()
    def decode_step(self, token, caches, cur_index):
        """One decode step.  token (B,) ints; ``cur_index`` an int or a
        (B,) tensor of positions.  Returns (logits (B, V) f32, caches);
        attention caches are updated in place."""
        x = self._embed(torch.as_tensor(token)[:, None])
        x, caches = self._run(x, None, "decode", caches, cur_index)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0], caches


def build_model(cfg, device=None, dtype=None, seed: int = 0,
                remat: str = "none") -> Model:
    return Model(cfg, device=device, dtype=dtype, seed=seed, remat=remat)
