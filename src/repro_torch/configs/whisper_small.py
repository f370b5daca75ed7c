"""Whisper-small [arXiv:2212.04356]: enc-dec audio; conv frontend STUBBED
(input_specs feeds precomputed 1500-frame embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
    vocab_size=51865, encoder_layers=12, encoder_seq=1500,
    frontend="audio",
)
