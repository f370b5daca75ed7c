"""The LM substrate's kernels: the RG-LRU linear scan, the Mamba-2
chunked SSD scan and flash attention, each as hand-written CUDA for the
card (``csrc/``, built with the engines' kernels by
``repro_torch.core.vecsim.kernels._build``), a plain PyTorch version for
the CPU (``<kernel>/ref.py``) and the wrapper the models call
(``<kernel>/ops.py``: ``rglru_scan``, ``ssd_chunk_scan``,
``flash_attention``), which picks between them by the device of its
tensors.  :data:`LAUNCHES` counts each wrapper's kernel launches."""

from .common import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
