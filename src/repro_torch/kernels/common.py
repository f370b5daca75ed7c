"""What the LM kernels' wrappers share: the launch counts, the route by
device, the checks, the element-type codes of the C entry points.

The wrappers follow the engines' kernel wrappers
(``repro_torch/core/vecsim/kernels/ops.py``): they check their tensors
(device, dtype, shape, contiguity), then a CUDA tensor goes to the
hand-written kernel on PyTorch's current stream — a failed build or
launch raises, there is no fallback — and a CPU tensor to the plain
version.  :data:`LAUNCHES` moves only where a kernel is launched.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["LAUNCHES", "reset_launches"]

#: kernel name -> launches since the last :func:`reset_launches`
#: (``rglru_scan_bwd``: the RG-LRU scan's reversed launch in a backward)
LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_bwd": 0,
                            "ssd_scan": 0, "flash_attention": 0}

# element-type codes of the C entry points (csrc/lm_common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def route(device: torch.device) -> bool:
    """True for the kernel, False for the plain version."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"the LM kernels run on 'cuda' or 'cpu', not "
                     f"{device.type!r}")


def check(name: str, x: torch.Tensor, shape: Tuple[int, ...],
          device: torch.device, dtype=None) -> None:
    """``x`` lies on ``device``, has ``shape`` and is contiguous; with
    ``dtype`` it has that type, without it float32 or bfloat16."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the other inputs on "
                         f"{device}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if dtype is None and x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def library():
    from repro_torch.core.vecsim.kernels import _build
    return _build.load_library()


def raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
