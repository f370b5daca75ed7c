"""Grok-1 314B [hf:xai-org/grok-1]: 8 experts top-2, d_ff=32768."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=32768,
    vocab_size=131072, n_experts=8, top_k=2,
)
