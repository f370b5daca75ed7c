"""The LM substrate's models: the dense, SSM (Mamba-2) and hybrid
(RecurrentGemma) families of the JAX package's ``models``, in PyTorch,
and ``convert`` to load the JAX package's weights."""

from .transformer import Model, build_model

__all__ = ["Model", "build_model"]
