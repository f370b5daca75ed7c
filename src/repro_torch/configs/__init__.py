"""Architecture configs and input shapes: the port's own copy of the
JAX package's ``configs`` (pure Python, copied as it is, so that the
port imports nothing of that package; ``tests/test_torch_models.py``
holds every field and ``param_count()`` equal to the original's)."""

from .base import SHAPES, ArchConfig, ShapeSpec, runnable_shapes
from .registry import ARCHS, get_arch

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "runnable_shapes",
           "ARCHS", "get_arch"]
