"""Qwen2-VL-72B [arXiv:2409.12191]: M-RoPE backbone; vision frontend
STUBBED (input_specs feeds precomputed patch embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
    vocab_size=152064, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, frontend="vision",
)
