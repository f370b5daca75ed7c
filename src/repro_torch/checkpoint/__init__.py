"""Sharded, atomic checkpoints (``ckpt``), on the JAX package's on-disk
format."""
