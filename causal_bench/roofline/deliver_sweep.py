"""Operations and bytes of one ``deliver_sweep`` launch, counted from its
inputs and outputs — a frozen copy of the ``deliver_sweep`` case of
``chip_smoke.py``'s ``_bound``.

Phase 5 of a gated round delivers every cell whose copy arrives this
round and counts each row's app and ping deliveries.  The least memory
traffic that work needs: ``delivered`` read once (4 bytes a cell);
``arr`` only in the 32-byte sectors where it decides a cell (an
undelivered cell of a live row); the changed sectors of ``delivered``
written; the crash flags, the column kinds and the two per-row
counters.  Operations: 6 integer operations a cell.  The bound of the
launch is the larger of the bytes over the card's memory rate and the
operations over its CUDA-core rate (``peaks.json``).

``WRAPPER`` names the program's wrapper that the harness wraps to take
each launch's inputs and outputs; ``KERNELS`` and ``LAUNCH_KERNEL``
name, in the device trace, the kernel a launch runs, once.
"""

from __future__ import annotations

__all__ = ["WRAPPER", "KERNELS", "LAUNCH_KERNEL", "before", "count"]

WRAPPER = ("repro_torch.core.vecsim.kernels", "deliver_sweep")
KERNELS = r"repro_torch::deliver_kernel\b"
LAUNCH_KERNEL = KERNELS


def _sectors(torch, mask):
    """32-byte sectors (8 int32 cells) of the plane that hold a cell of
    ``mask``, as a 0-d tensor."""
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, 8).any(dim=1).sum()


def before(torch, args):
    """What the count needs of the inputs, taken before the launch
    (which writes ``delivered`` in place): where ``delivered`` is not
    yet set (a sweep only sets such cells)."""
    return args[1] < 0


def count(torch, args, snap):
    """``(bytes, operations)`` of the launch ``args`` (the wrapper's
    arguments, ``delivered`` now holding the output), as 0-d int64
    tensors on the plane's device, so that counting never waits for
    the card."""
    d_out, crashed = args[1], args[2]
    d_unset = snap
    n, w = d_unset.shape
    cells = n * w
    need_arr = d_unset & ~crashed[:, None]
    d_changed = d_unset & (d_out >= 0)
    nbytes = (4 * cells + n + w + 8 * n + 32 * _sectors(torch, d_changed)
              + 32 * _sectors(torch, need_arr))
    ops = torch.full_like(nbytes, 6 * cells)
    return nbytes, ops
