"""Architecture configs and input-shape registry.

One ``ArchConfig`` per assigned architecture (exact numbers from the
assignment table) plus ``smoke()`` reductions for CPU tests.  Shapes are
global (pre-sharding): ``train_4k`` lowers ``train_step``; ``prefill_32k``
lowers the serving prefill; ``decode_32k``/``long_500k`` lower
``serve_step`` (one token against a seq_len KV cache).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "runnable_shapes"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25       # training dispatch capacity
    capacity_factor_eval: float = 2.0   # serving dispatch capacity

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4

    # hybrid (RecurrentGemma / Griffin): block pattern repeated over depth
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window: int = 0                       # local-attention window
    lru_width: int = 0                    # 0 -> d_model

    # encoder-decoder (whisper): backbone sizes apply to the decoder
    encoder_layers: int = 0
    encoder_seq: int = 0                  # precomputed frame embeddings
    frontend: str = "none"                # none | audio | vision (stub)

    # VLM
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = ()  # per-section head_dim/2 split

    # numerics / implementation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "blockwise"   # blockwise (flash-style) | naive

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    # ---------------- derived ------------------------------------------- #
    @property
    def attn_q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def attn_kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and not self.block_pattern

    @property
    def is_hybrid(self) -> bool:
        return bool(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can serve 500k+ contexts (SSM state and/or windowed attention)."""
        return self.is_ssm or self.is_hybrid

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind over the full depth."""
        if self.is_ssm:
            return ("ssm",) * self.num_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    # ---------------- parameter count (for roofline / memory) ----------- #
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb + d  # final norm
        if self.encoder_layers:
            n += self.encoder_seq * 0  # frontend embeddings are inputs
        for kind in self.layer_kinds():
            n += d  # pre-norm 1
            if kind == "attn":
                n += d * self.attn_q_dim + 2 * d * self.attn_kv_dim
                n += self.attn_q_dim * d
                if self.qk_norm:
                    n += 2 * self.head_dim
            elif kind == "rec":
                w = self.lru_width or d
                n += 2 * d * w + w * d          # in gates + out
                n += self.conv_width * w + 3 * w  # conv + lru params
            elif kind == "ssm":
                di, ns, h = self.d_inner, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * ns + h) + self.conv_width * (
                    di + 2 * ns) + 2 * h + di + di * d
            if kind != "ssm":
                n += d  # pre-norm 2
                if self.is_moe:
                    n += d * self.n_experts
                    n += self.n_experts * 3 * d * self.d_ff
                else:
                    n += 3 * d * self.d_ff
        if self.encoder_layers:
            de = self.d_model
            per = (2 * de  # norms
                   + de * self.attn_q_dim + 2 * de * self.attn_kv_dim
                   + self.attn_q_dim * de + 3 * de * self.d_ff)
            n += self.encoder_layers * per + de
            # decoder cross-attention adds one attention block per layer
            n += self.num_layers * (de + de * self.attn_q_dim
                                    + 2 * de * self.attn_kv_dim
                                    + self.attn_q_dim * de)
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        expert = self.num_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.num_layers * self.top_k * 3 * self.d_model * self.d_ff
        return full - expert + active

    # ---------------- smoke reduction ------------------------------------ #
    def smoke(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers, 4 if not self.block_pattern
                           else 2 * max(1, len(self.block_pattern))),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.lru_width:
            kw.update(lru_width=64)
        if self.window:
            kw.update(window=32)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=24)
        if self.mrope_sections:
            kw.update(mrope_sections=(4, 2, 2))
        if self.num_kv_heads == self.num_heads:  # MHA archs stay MHA
            kw.update(num_kv_heads=4)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def runnable_shapes(cfg: ArchConfig):
    """Shapes applicable to an arch; ``long_500k`` requires sub-quadratic
    serving (DESIGN.md §4 documents the skips)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return out
