"""Decoder-LM stack (plus the whisper-style encoder-decoder) of every
family: dense, MoE, SSM, hybrid, encoder-decoder and M-RoPE.

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
(conv_state, ssm_state) for Mamba-2.  An encoder-decoder's superblocks
also hold ``"b0_x"``: the cross-attention (k, v) of (B, S_enc, KV, D),
computed once from the encoder's output by the prefill and passed
through by every decode step.

The entry points take ``tokens`` or ``embeds`` (the VLM frontend's
stub), ``positions`` ((B, S), or (B, 3, S) for an M-RoPE arch; by
default 0..S-1 in every stream) and, for an encoder-decoder,
``enc_embeds`` (the audio frontend's stub), as the JAX package's do.
An MoE layer returns its balance loss; ``forward_aux`` hands the sum to
the train step, ``forward`` the logits alone.

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
(``dots_saveable``, through selective checkpointing).

Distribution: every parameter carries its logical axes
(:meth:`Model.param_axes`), which ``repro_torch.sharding.policy`` maps to
DTensor placements; bound to DTensor parameters (``training.step.bound``)
the same code runs sharded.  ``seq_shard`` keeps the residual stream
sequence-sharded over "model" between layers outside decode
(Megatron-SP), with q/k/v re-gathered once before blockwise attention,
at JAX's constrain sites; without an ambient mesh it changes nothing.
JAX's ``unroll`` knob is not ported: it unrolls the layer scan so that
XLA's cost analysis, which counts a scan body once, prices every layer;
the superblock loop here is Python, so every layer is counted already
and the knob would change nothing.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint as ckpt

from ..backend import resolve_device
from .layers import (attention, decode_attention, decode_cross_attention,
                     embed_lookup, init_dense, mlp, rms_norm, split_dim)
from .moe import MoE, moe_ffn
from .rglru import RGLRU, rglru_decode_step, rglru_forward
from .ssm import SSM, _param, ssd_forward, ssm_decode_step

__all__ = ["Model", "build_model", "StackSpec", "stack_layout",
           "cache_seq_len", "REMATS"]

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
        self.wq = _param(init_dense(gen, (d, qd), dtype, device),
                         ("embed", "q_proj"))
        self.wk = _param(init_dense(gen, (d, kvd), dtype, device),
                         ("embed", "kv_proj"))
        self.wv = _param(init_dense(gen, (d, kvd), dtype, device),
                         ("embed", "kv_proj"))
        self.wo = _param(init_dense(gen, (qd, d), dtype, device),
                         ("q_proj", "embed"))
        if cfg.qk_norm:
            self.q_norm = _param(torch.ones(cfg.head_dim, dtype=dtype,
                                            device=device), ("head_dim",))
            self.k_norm = _param(torch.ones(cfg.head_dim, dtype=dtype,
                                            device=device), ("head_dim",))


class MLP(nn.Module):
    def __init__(self, d, d_ff, dtype, device, gen):
        super().__init__()
        self.w_gate = _param(init_dense(gen, (d, d_ff), dtype, device),
                             ("embed", "mlp"))
        self.w_up = _param(init_dense(gen, (d, d_ff), dtype, device),
                           ("embed", "mlp"))
        self.w_down = _param(init_dense(gen, (d_ff, d), dtype, device),
                             ("mlp", "embed"))


class Layer(nn.Module):
    """One block: pre-norm, the mixer (``attn``, ``rec`` or ``ssm``);
    with ``cross`` (an encoder-decoder's decoder) a pre-norm cross
    attention ``xattn``; and for every kind but ssm a pre-norm SwiGLU
    MLP, or for an MoE arch the experts ``moe``."""

    def __init__(self, cfg, kind: str, dtype, device, gen,
                 cross: bool = False):
        super().__init__()
        self.kind = kind
        self.ln1 = _param(torch.ones(cfg.d_model, dtype=dtype, device=device),
                          ("embed",))
        if kind == "attn":
            self.attn = Attention(cfg, dtype, device, gen)
        elif kind == "rec":
            self.rec = RGLRU(cfg, dtype, device, gen)
        else:
            self.ssm = SSM(cfg, dtype, device, gen)
        if cross:
            self.ln_x = _param(torch.ones(cfg.d_model, dtype=dtype,
                                          device=device), ("embed",))
            self.xattn = Attention(cfg, dtype, device, gen)
        if _has_mlp(cfg, kind):
            self.ln2 = _param(torch.ones(cfg.d_model, dtype=dtype,
                                         device=device), ("embed",))
            if cfg.is_moe:
                self.moe = MoE(cfg, dtype, device, gen)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, gen)


def apply_layer(layer: Layer, cfg, x, positions, mode: str, cache=None,
                cur_index=None, enc_out=None, mask_kind=None,
                seq_shard: bool = False):
    """Returns (x, new_cache, aux): aux the MoE layer's balance loss, None
    for a layer without experts.  ``enc_out`` is the encoder's output in
    "train" and "prefill" mode, the layer's cached cross (k, v) in
    "decode"; the MoE routes at ``capacity_factor`` in "train" mode,
    at ``capacity_factor_eval`` otherwise.  Each sublayer's output joins
    the residual in its layout (:func:`_residual`; under a mesh the
    row-parallel products' partial sums are reduced there)."""
    kind = layer.kind
    aux = None
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    if kind == "attn":
        if mode == "decode":
            out, ck, cv = decode_attention(layer.attn, cfg, h, cache[0],
                                           cache[1], cur_index,
                                           window=cfg.window)
            new_cache = (ck, cv)
        else:
            mk = mask_kind or ("local" if cfg.window else "causal")
            out, new_cache = attention(layer.attn, cfg, h, positions, mk,
                                       seq_shard=seq_shard)
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
    x = x + _residual(out, seq_shard and mode != "decode")
    if hasattr(layer, "xattn"):
        h = rms_norm(x, layer.ln_x, cfg.norm_eps)
        if mode == "decode":
            out = decode_cross_attention(layer.xattn, cfg, h, *enc_out)
        else:
            out, _ = attention(layer.xattn, cfg, h, positions,
                               xattn_kv=enc_out)
        x = x + _residual(out, seq_shard and mode != "decode")
    if _has_mlp(cfg, kind):
        h = rms_norm(x, layer.ln2, cfg.norm_eps)
        if cfg.is_moe:
            y, aux = moe_ffn(layer.moe, cfg, h, train=(mode == "train"))
        else:
            y = mlp(layer.mlp, h)
        x = x + _residual(y, seq_shard and mode != "decode")
    return x, new_cache, aux


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


def _add(total, aux):
    """A running sum of balance losses, None while there is none."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _residual(x, seq_shard: bool):
    """The residual stream's layout between layers under an ambient mesh
    (a no-op without one): the batch over ("pod", "data") and, with
    ``seq_shard``, the sequence over "model" (Megatron-SP), as the JAX
    stack constrains it; without it replicated over "model".  JAX's
    partitioner infers the second layout from the whole program; DTensor
    picks each op's layout from its inputs alone, so the port states it
    (after the embedding, too)."""
    from ..sharding.policy import constrain
    return constrain(x, ("pod", "data"), "model" if seq_shard else None,
                     None)


def _run_block(block, cfg, x, positions, enc_out=None, mask_kind=None,
               seq_shard: bool = False):
    """One superblock of the training forward; returns (x, aux)."""
    aux = None
    for layer in block.values():
        x, _, a = apply_layer(layer, cfg, x, positions, "train",
                              enc_out=enc_out, mask_kind=mask_kind,
                              seq_shard=seq_shard)
        x = _residual(x, seq_shard)
        aux = _add(aux, a)
    return x, aux


def _remat_block(remat: str, block, cfg, x, positions, enc_out=None,
                 mask_kind=None, seq_shard: bool = False):
    """:func:`_run_block` with its activations recomputed in the backward
    (``remat`` "full" or "dots"); the aux comes out of the checkpointed
    superblock beside x."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(_run_block, block, cfg, x, positions, enc_out,
                           mask_kind, seq_shard, use_reentrant=False, **kw)


# ------------------------------------------------------------------ #
# full model
# ------------------------------------------------------------------ #
class Model(nn.Module):
    """The LM of one ``ArchConfig``, its weights drawn at random.

    ``device`` is resolved by ``repro_torch.backend.resolve_device`` (the
    card unless ``"cpu"`` is asked for); ``dtype`` is the parameters'
    type (default ``cfg.param_dtype``; an MoE router is float32
    whatever it is); the weights come from ``generator`` (a
    ``torch.Generator`` on ``device``) or from one seeded with ``seed``.
    They cannot equal the JAX package's ``Model.init`` draws;
    ``repro_torch.models.convert`` loads those.  The parameters require
    grad (``repro_torch.training`` trains them); ``remat`` is one of
    :data:`REMATS`; ``seq_shard`` as in the module's docstring.
    ``device="meta"`` builds the shapes alone, for the dry-run's
    abstract cells (``repro_torch.launch.specs``).  Activations run in
    ``cfg.compute_dtype``.  An encoder-decoder also has ``enc_stack``
    (``encoder_layers`` superblocks of one attention layer under a full
    mask) and ``enc_norm``."""

    def __init__(self, cfg, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 remat: str = "none", seq_shard: bool = False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        self.remat = remat
        self.seq_shard = seq_shard
        self.cfg = cfg
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        dtype = dtype or getattr(torch, cfg.param_dtype)
        gen = None if meta else (
            generator or torch.Generator(device=dev).manual_seed(seed))
        self.embed = _param((torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen,
            dtype=torch.float32, device=dev) * 0.02).to(dtype),
            ("vocab", "embed"))
        self.stacks = nn.ModuleList([
            nn.ModuleList([
                nn.ModuleDict({f"b{i}": Layer(cfg, kind, dtype, dev, gen,
                                              cross=cfg.is_encdec)
                               for i, kind in enumerate(spec.pattern)})
                for _ in range(spec.n_rep)])
            for spec in stack_layout(cfg)])
        self.final_norm = _param(torch.ones(cfg.d_model, dtype=dtype,
                                            device=dev), ("embed",))
        if not cfg.tie_embeddings:
            self.head = _param(init_dense(gen, (cfg.d_model, cfg.vocab_size),
                                          dtype, dev), ("embed", "vocab"))
        if cfg.is_encdec:
            self.enc_stack = nn.ModuleList([
                nn.ModuleDict({"b0": Layer(cfg, "attn", dtype, dev, gen)})
                for _ in range(cfg.encoder_layers)])
            self.enc_norm = _param(torch.ones(cfg.d_model, dtype=dtype,
                                              device=dev), ("embed",))

    def param_axes(self):
        """Parameter name -> its logical axes (the JAX package's axes
        tree, keyed by the port's names; a leaf stacked per superblock
        there has its leading ``"layers"`` dropped here)."""
        return {name: p.logical_axes for name, p in self.named_parameters()}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # ---------------- helpers ----------------------------------------- #
    def _embed(self, tokens):
        """The rows of ``embed`` (a lookup that a vocab-sharded DTensor
        table serves shard by shard, never gathered whole)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return embed_lookup(self.embed, tokens).to(self.compute_dtype)

    def _inputs(self, tokens, embeds):
        """The token embeddings, or ``embeds`` (B, S, d) in their place,
        in the residual stream's layout."""
        if embeds is None:
            return _residual(self._embed(tokens), self.seq_shard)
        return _residual(torch.as_tensor(embeds, device=self.device).to(
            self.compute_dtype), self.seq_shard)

    def _logits(self, x):
        head = self.embed.t() if self.cfg.tie_embeddings else self.head
        return (x @ head.to(x.dtype)).float()

    def _positions(self, x, positions=None):
        """``positions`` on the device, or 0..S-1 for every row — in all
        three streams, (B, 3, S), for an M-RoPE arch."""
        if positions is not None:
            return torch.as_tensor(positions, device=x.device)
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device, dtype=torch.int32)[
            None].expand(b, s)
        return pos[:, None].expand(b, 3, s) if self.cfg.mrope else pos

    def _block(self, block, x, positions, enc_out=None, mask_kind=None):
        """One superblock of the training forward; returns (x, aux)."""
        if self.remat != "none" and torch.is_grad_enabled():
            return _remat_block(self.remat, block, self.cfg, x, positions,
                                enc_out, mask_kind, self.seq_shard)
        return _run_block(block, self.cfg, x, positions, enc_out, mask_kind,
                          self.seq_shard)

    def encode(self, enc_embeds):
        """The bidirectional encoder over the frontend's embeddings (B,
        S_enc, d): (B, S_enc, d) in the compute type."""
        x = torch.as_tensor(enc_embeds, device=self.device).to(
            self.compute_dtype)
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device, dtype=torch.int32)[
            None].expand(b, s)
        for block in self.enc_stack:
            x, _ = self._block(block, x, pos, mask_kind="full")
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def _encoded(self, enc_embeds):
        if not self.cfg.is_encdec:
            return None
        if enc_embeds is None:
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder: pass enc_embeds "
                f"(B, S_enc, d_model), the frontend's output")
        return self.encode(enc_embeds)

    def _run(self, x, positions, mode: str, caches=None, cur_index=None,
             enc_out=None):
        """Every decoder layer in order; returns (x, caches, aux) with the
        caches of the prefill or decode mode (None in "train") and the
        summed balance loss (None without experts)."""
        aux = None
        if mode == "train":
            for stack in self.stacks:
                for block in stack:
                    x, a = self._block(block, x, positions, enc_out)
                    aux = _add(aux, a)
            return x, None, aux
        out = []
        for s, stack in enumerate(self.stacks):
            stack_out = []
            for r, block in enumerate(stack):
                cached = caches[s][r] if caches is not None else None
                new_c = {}
                for name, layer in block.items():
                    c_in, eo = None, enc_out
                    if cached is not None:
                        c_in = cached[name]
                        eo = cached.get(f"{name}_x")
                        if eo is not None:
                            new_c[f"{name}_x"] = eo
                    x, new_c[name], a = apply_layer(
                        layer, self.cfg, x, positions, mode, cache=c_in,
                        cur_index=cur_index, enc_out=eo,
                        seq_shard=self.seq_shard and mode != "decode")
                    if mode != "decode":
                        x = _residual(x, self.seq_shard)
                    aux = _add(aux, a)
                stack_out.append(new_c)
            out.append(stack_out)
        return x, out, aux

    def _cross_kv(self, layer, enc_out):
        """A decoder layer's cross-attention (k, v) of the encoder output,
        each (B, S_enc, KV, D)."""
        cd = enc_out.dtype
        heads = (self.cfg.num_kv_heads, self.cfg.head_dim)
        return (split_dim(enc_out @ layer.xattn.wk.to(cd), 2, heads),
                split_dim(enc_out @ layer.xattn.wv.to(cd), 2, heads))

    # ---------------- entry points ------------------------------------ #
    def forward_aux(self, tokens=None, positions=None, embeds=None,
                    enc_embeds=None):
        """Full-sequence logits (B, S, V) f32 and the summed MoE balance
        loss (a f32 scalar, 0 for an arch without experts).  ``tokens``
        (B, S), or ``embeds`` (B, S, d) in their place; ``positions`` as
        :meth:`_positions` takes them; ``enc_embeds`` (B, S_enc, d) for
        an encoder-decoder.  The MoE routes at its training capacity."""
        x = self._inputs(tokens, embeds)
        enc_out = self._encoded(enc_embeds)
        x, _, aux = self._run(x, self._positions(x, positions), "train",
                              enc_out=enc_out)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(x), aux

    def forward(self, tokens=None, positions=None, embeds=None,
                enc_embeds=None):
        """The logits of :meth:`forward_aux` alone."""
        return self.forward_aux(tokens, positions, embeds, enc_embeds)[0]

    @torch.no_grad()
    def prefill(self, tokens=None, positions=None, embeds=None,
                enc_embeds=None, pad_to: Optional[int] = None):
        """Run the prompt (inputs as :meth:`forward_aux` takes them);
        return (last-token logits (B, V) f32, serving caches).  Attention
        caches hold ``pad_to`` slots (default S), or ``min(pad_to,
        window)`` for windowed layers; an encoder-decoder's also hold each
        layer's cross (k, v) as ``"b{i}_x"``.  The MoE routes at its
        serving capacity."""
        x = self._inputs(tokens, embeds)
        s = x.shape[1]
        enc_out = self._encoded(enc_embeds)
        x, caches, _ = self._run(x, self._positions(x, positions), "prefill",
                                 enc_out=enc_out)
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
                    if enc_out is not None:
                        block_caches[f"{name}_x"] = self._cross_kv(layer,
                                                                   enc_out)
        return logits, caches

    @torch.no_grad()
    def decode_step(self, token, caches, cur_index):
        """One decode step.  token (B,) ints; ``cur_index`` an int or a
        (B,) tensor of positions.  Returns (logits (B, V) f32, caches);
        attention caches are updated in place, cross (k, v) passed
        through."""
        x = self._embed(torch.as_tensor(token)[:, None])
        x, caches, _ = self._run(x, None, "decode", caches, cur_index)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0], caches


def build_model(cfg, device=None, dtype=None, seed: int = 0,
                remat: str = "none", seq_shard: bool = False) -> Model:
    return Model(cfg, device=device, dtype=dtype, seed=seed, remat=remat,
                 seq_shard=seq_shard)
