"""The kernels of the round body, the retirement sweep, the latency
telemetry and the sharded engine's frontier exchange: hand-written CUDA
for the card (``csrc/``), plain PyTorch versions for the CPU
(``ref.py``), and the wrappers the engines call (``ops.py``).  The
frontier bit-plane helpers of the sharded fast body are plain tensor
operations on every route."""

from .ops import (LAUNCHES, deliver_sweep, frontier_sweep, fused_sweep,
                  latency_hist, reset_launches, retire_reduce, retire_scan,
                  ring_apply, slot_frontier)
from .ref import pack_columns, popcount_bytes, unpack_columns

__all__ = ["LAUNCHES", "reset_launches", "fused_sweep", "deliver_sweep",
           "frontier_sweep", "retire_reduce", "retire_scan", "latency_hist",
           "slot_frontier", "ring_apply", "pack_columns", "unpack_columns",
           "popcount_bytes"]
