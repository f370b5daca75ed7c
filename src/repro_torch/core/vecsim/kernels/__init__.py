"""The kernels of the round body, the retirement sweep and the latency
telemetry: hand-written CUDA for the card (``csrc/``), plain PyTorch
versions for the CPU (``ref.py``), and the wrappers the engines call
(``ops.py``)."""

from .ops import (LAUNCHES, deliver_sweep, frontier_sweep, fused_sweep,
                  latency_hist, reset_launches, retire_reduce, retire_scan)

__all__ = ["LAUNCHES", "reset_launches", "fused_sweep", "deliver_sweep",
           "frontier_sweep", "retire_reduce", "retire_scan", "latency_hist"]
