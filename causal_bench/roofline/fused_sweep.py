"""Operations and bytes of one ``fused_sweep`` launch, counted from its
inputs and outputs — a frozen copy of the ``fused_sweep`` case of
``chip_smoke.py``'s ``_bound``.

The gating-free round delivers every cell whose copy arrives this
round and pulls, for every cell delivered this round, ``t + delay``
into the cells its out-links reach.  The least memory traffic that
work needs: ``delivered`` read once (4 bytes a cell); ``arr`` only in
the 32-byte sectors where it decides a cell (undelivered cells of live
rows) or is lowered; the changed sectors of both planes written; the
crash flags, the column kinds and the two per-row counters; 9 bytes of
slot table a slot of each row that delivered.  Operations: 6 integer
operations a cell and 3 a send.  The bound of the launch is the larger
of the bytes over the card's memory rate and the operations over its
CUDA-core rate (``peaks.json``).

``WRAPPER`` names the program's wrapper that the harness wraps to take
each launch's inputs and outputs; ``KERNELS`` and ``LAUNCH_KERNEL``
name, in the device trace, the kernels a launch runs and the one it
runs once.
"""

from __future__ import annotations

__all__ = ["WRAPPER", "KERNELS", "LAUNCH_KERNEL", "before", "count"]

WRAPPER = ("repro_torch.core.vecsim.kernels", "fused_sweep")
KERNELS = r"repro_torch::(plane_kernel|forward_kernel)\b"
LAUNCH_KERNEL = r"repro_torch::plane_kernel\b"


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
    (which writes ``arr`` and ``delivered`` in place): ``arr``, and
    where ``delivered`` is not yet set (a sweep only sets such cells)."""
    arr, delivered = args[0], args[1]
    return arr.clone(), delivered < 0


def count(torch, args, snap):
    """``(bytes, operations)`` of the launch ``args`` (the wrapper's
    arguments, its planes now holding the outputs), as 0-d int64
    tensors on the planes' device, so that counting never waits for
    the card."""
    arr_out, d_out, crashed, adj = args[0], args[1], args[2], args[3]
    t = int(args[7])
    arr_in, d_unset = snap
    n, w = d_unset.shape
    k = adj.shape[1]
    cells = n * w
    d_changed = d_unset & (d_out >= 0)
    a_changed = arr_out != arr_in
    need_arr = (d_unset & ~crashed[:, None]) | a_changed
    now = d_out == t
    s_d, s_a, s_need = (_sectors(torch, d_changed),
                        _sectors(torch, a_changed), _sectors(torch, need_arr))
    rows_now, cells_now = now.any(dim=1).sum(), now.sum()
    nbytes = (4 * cells + n + w + 8 * n + 32 * s_d + 9 * k * rows_now
              + 32 * s_a + 32 * s_need)
    ops = 6 * cells + 3 * k * cells_now
    return nbytes, ops
