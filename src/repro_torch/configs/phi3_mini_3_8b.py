"""Phi-3-mini 3.8B [arXiv:2404.14219]: RoPE + SwiGLU, kv=32 (MHA)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, head_dim=96, d_ff=8192,
    vocab_size=32064,
)
