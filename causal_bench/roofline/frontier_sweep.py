"""Operations and bytes of one ``frontier_sweep`` launch, counted from
its inputs and outputs — a frozen copy of the ``frontier_sweep`` case of
``chip_smoke.py``'s ``_bound``.

Phases 7 and 8 of a gated round flush, over each slot whose pong has
arrived (``do``), the app columns delivered since its gate, and forward
this round's deliveries over the safe slots (``fwd_ok``), in one
scatter-min.  The least memory traffic that work needs: ``delivered``
read once (4 bytes a cell) and the column kinds; each slot table only
where the output depends on it — ``do`` on rows with an app cell before
the round, ``fwd_ok`` on rows with a cell delivered in it, the gates of
the ``do`` slots of the former, ``adj`` and ``delay`` of the slots that
send; the changed ``arr`` sectors read and written.  Operations: a
compare a cell, a compare and a min a send.  The bound of the launch
is the larger of the bytes over the card's memory rate and the
operations over its CUDA-core rate (``peaks.json``).

``WRAPPER`` names the program's wrapper that the harness wraps to take
each launch's inputs and outputs; ``KERNELS`` and ``LAUNCH_KERNEL``
name, in the device trace, the kernel a launch runs, once.
"""

from __future__ import annotations

__all__ = ["WRAPPER", "KERNELS", "LAUNCH_KERNEL", "before", "count"]

WRAPPER = ("repro_torch.core.vecsim.kernels", "frontier_sweep")
KERNELS = r"repro_torch::frontier_kernel\b"
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
    (which writes ``arr`` in place): ``arr``."""
    return args[0].clone()


def count(torch, args, snap):
    """``(bytes, operations)`` of the launch ``args`` (the wrapper's
    arguments, ``arr`` now holding the output), as 0-d int64 tensors on
    the planes' device, so that counting never waits for the card."""
    arr_out, d, adj, _, gate, do, fwd, is_app = args[:8]
    t = int(args[8])
    n, w = d.shape
    k = adj.shape[1]
    cells = n * w
    now = d == t
    early = (d < t) & is_app[None, :]
    rows_early = early.any(dim=1)
    rows_now = now.any(dim=1)
    latest = torch.where(early, d, torch.full_like(d, -2)).amax(dim=1)
    flush_slot = do & rows_early[:, None] & (latest[:, None] >= gate)
    send_slot = (fwd & rows_now[:, None]) | flush_slot
    a_changed = arr_out != snap
    nbytes = (4 * cells + w + 8 + k * rows_early.sum()
              + k * rows_now.sum()
              + 4 * (do & rows_early[:, None]).sum()
              + 8 * send_slot.sum() + 64 * _sectors(torch, a_changed))
    sends = sum(((now & fwd[:, kk, None])
                 | (early & do[:, kk, None] & (d >= gate[:, kk, None]))).sum()
                for kk in range(k))
    ops = cells + 2 * sends
    return nbytes, ops
