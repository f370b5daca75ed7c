"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B scaled per assignment]:
128 experts top-8, expert d_ff=1536, GQA kv=4."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    vocab_size=151936, qk_norm=True, n_experts=128, top_k=8,
    rope_theta=1e6,
)
