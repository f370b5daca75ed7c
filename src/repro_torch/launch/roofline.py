"""Roofline accounting of the dry-run's traced cells.

The port of the JAX package's ``launch/roofline.py``.  Three terms per
(arch x shape x mesh), in seconds:

    compute    = flops            / (chips x peak bf16 FLOP/s)
    memory     = bytes            / (chips x HBM bytes/s)
    collective = collective_bytes / (chips x link bytes/s)

on the H100's numbers (:data:`HW`), not the TPU v5e's of the JAX
package.  The flops and bytes are what the dry-run's counter sees one
device run (``launch/dryrun.py``); the collective bytes come from each
collective the fake process group is asked for, priced by the same ring
model as JAX's ``parse_collectives`` (:func:`wire_bytes`) — the port has
no HLO text to parse.  ``model_flops`` is the analytic 6·N·D (dense) /
6·N_active·D (MoE) plus attention/SSD terms, copied, so the
useful-compute ratio exposes remat and dispatch overheads.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["HW", "wire_bytes", "terms_from", "model_flops", "dominant"]

#: H100 SXM5 (per card): 989 TFLOP/s dense bf16 and 3.35 TB/s of HBM3
#: from NVIDIA's H100 datasheet, 80 GB of HBM; ``link_bw`` is the link a
#: 16-wide "model" axis crosses on 8-GPU H100 nodes (DGX H100 / HGX
#: H100): the axis spans two nodes, so its ring is paced by the
#: inter-node hop, one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7,
#: DGX H100 system datasheet) = 50e9 bytes/s each way; NVLink's 450 GB/s
#: a direction inside a node is not the bound.
HW = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9, hbm_bytes=80e9)

#: the collectives the ring model prices
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


def wire_bytes(op: str, result_bytes: float, group: int) -> float:
    """Per-device wire bytes of one collective (ring cost model), from
    the bytes of its per-device result and its group's size:

      all-gather:         result x (g-1)/g  (receives g-1 chunks of result/g)
      all-reduce:         2 x result x (g-1)/g
      reduce-scatter:     result x (g-1)    (the result is the 1/g shard)
      all-to-all:         result x (g-1)/g
      collective-permute: result
    """
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}")
    if op == "collective-permute":
        return float(result_bytes)
    g = int(group)
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    return result_bytes * (g - 1) / g


def terms_from(flops: float, bytes_hbm: float, wire_per_device: float,
               chips: int) -> Dict[str, float]:
    """Three roofline terms in seconds.  ``flops``/``bytes_hbm`` are
    whole-step totals across chips; wire bytes are per device, so
    collective_bytes = wire x chips."""
    compute = flops / (chips * HW["peak_flops"])
    memory = bytes_hbm / (chips * HW["hbm_bw"])
    coll = (wire_per_device * chips) / (chips * HW["link_bw"])
    return dict(compute=compute, memory=memory, collective=coll)


def dominant(terms: Dict[str, float]) -> str:
    return max(("compute", "memory", "collective"), key=lambda k: terms[k])


# ------------------------------------------------------------------ #
# analytic MODEL_FLOPS
# ------------------------------------------------------------------ #
def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step (global): the 6·N·D convention + attention.

    train: 6 x active-params x tokens + attention/SSD sequence terms
    prefill: 2 x active-params x tokens + fwd attention
    decode: 2 x active-params x batch (one token per sequence)."""
    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()
    kinds = cfg.layer_kinds()

    def seq_extra(mult: float, seq: int) -> float:
        """attention-like S^2 terms; coefficient convention: the causal
        QK^T+PV pair costs 2*B*S*span*H*hd flops forward (2 matmuls x 2
        flops / 2 causal), so mult = 2 for fwd-only and 6 for training."""
        total = 0.0
        for kind in kinds:
            if kind == "attn":
                win = cfg.window or seq
                kv_span = min(seq, win)
                total += mult * b * seq * kv_span * cfg.num_heads * \
                    cfg.head_dim  # QK^T + PV, causal halving folded in
            elif kind == "ssm":
                q, n, h, p = (cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_heads,
                              cfg.ssm_head_dim)
                fwd = 2 * b * seq * (q * n + h * q * p + 2 * h * n * p)
                total += fwd * (mult / 2)
            elif kind == "rec":
                w = cfg.lru_width or cfg.d_model
                total += (mult / 2) * 2 * b * seq * 4 * w  # gates+scan, cheap
        if cfg.is_encdec:
            # encoder self-attn + decoder cross-attn
            es = cfg.encoder_seq
            total += cfg.encoder_layers * mult * b * es * es * \
                cfg.num_heads * cfg.head_dim
            total += len(kinds) * mult * b * seq * es * cfg.num_heads * \
                cfg.head_dim
        return total

    if shape.kind == "train":
        return 6.0 * n_active * b * s + seq_extra(6.0, s)
    if shape.kind == "prefill":
        return 2.0 * n_active * b * s + seq_extra(2.0, s)
    # decode: one token per sequence against an s-long context
    attn_read = 0.0
    for kind in kinds:
        if kind == "attn":
            span = min(s, cfg.window or s)
            attn_read += 4.0 * b * span * cfg.num_heads * cfg.head_dim
        elif kind == "ssm":
            attn_read += 4.0 * b * cfg.ssm_heads * cfg.ssm_state * \
                cfg.ssm_head_dim
    return 2.0 * n_active * b + attn_read
