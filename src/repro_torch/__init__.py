"""PyTorch/CUDA port of the causal-broadcast simulator.

The package runs PC-broadcast (the paper's Algorithm 2) and R-broadcast
through the monolithic and streaming windowed vectorized engines on an
NVIDIA H100, with the per-round ``(N, W)`` sweeps done by hand-written
CUDA kernels (``core/vecsim/kernels/csrc``).  Module paths mirror the JAX
package ``repro`` so each counterpart is easy to find; this package
imports nothing from it.

Front door: ``repro_torch.api.run(RunSpec(...))`` or
``python -m repro_torch.api``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
