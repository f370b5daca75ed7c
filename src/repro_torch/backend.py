"""Where the port runs: the H100, or the CPU when the caller asks for it.

Every entry point takes ``device=None`` and resolves it here.  ``None``
(and ``"cuda"``) means the card; there is no automatic fallback to the
CPU, so a run that was meant for the card never silently measures the
host.  The CUDA kernels are built for ``sm_90a`` (Hopper), so a card of
another capability is refused here rather than at the first launch.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

__all__ = ["cuda_available", "resolve_device", "DeviceUnavailableError",
           "KERNEL_CAPABILITY"]

#: compute capability the hand-written kernels are compiled for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


class DeviceUnavailableError(RuntimeError):
    """The card was asked for (explicitly or by default) and is not
    usable here."""


def cuda_available() -> Tuple[bool, str]:
    """(ok, note): can the port's CUDA kernels run here, and on what."""
    if not torch.cuda.is_available():
        return False, (f"torch {torch.__version__} sees no CUDA device "
                       f"(built for CUDA {torch.version.cuda})")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    if tuple(cap) != KERNEL_CAPABILITY:
        return False, (f"{name} has compute capability {cap}; the kernels "
                       f"are built for sm_90a {KERNEL_CAPABILITY}")
    return True, f"{name}, compute capability {cap}"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` or ``"cuda"`` -> the card, which must be a Hopper (sm_90)
    GPU; ``"cpu"`` -> the CPU, where every kernel is replaced by its
    plain PyTorch version.  Anything else raises :class:`ValueError`; a
    card request without a usable card raises
    :class:`DeviceUnavailableError`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device={device!r}: the port runs on 'cuda' "
                         "(the default) or 'cpu'")
    ok, note = cuda_available()
    if not ok:
        raise DeviceUnavailableError(
            f"no usable CUDA device ({note}); pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)
