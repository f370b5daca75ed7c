"""Granite-8B (code) [arXiv:2405.04324]: llama-arch, GQA kv=8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=49152, tie_embeddings=True,
)
