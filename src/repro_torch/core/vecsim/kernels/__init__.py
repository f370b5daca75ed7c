"""The delivery-sweep kernels of the round body: hand-written CUDA for
the card (``csrc/``), plain PyTorch versions for the CPU (``ref.py``),
and the wrappers the engines call (``ops.py``)."""

from .ops import (LAUNCHES, deliver_sweep, frontier_sweep, fused_sweep,
                  reset_launches, retire_reduce)

__all__ = ["LAUNCHES", "reset_launches", "fused_sweep", "deliver_sweep",
           "frontier_sweep", "retire_reduce"]
