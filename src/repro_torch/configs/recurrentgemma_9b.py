"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attention 1:2
(pattern rec,rec,attn), MQA kv=1, window 2048."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, block_pattern=("rec", "rec", "attn"),
    window=2048, lru_width=4096, tie_embeddings=True,
)
