"""Wrappers of the delivery-sweep, retirement, telemetry and
sharded-exchange kernels: the only way the engines reach them.

Each wrapper checks its tensors (device, dtype, shape, contiguity) and
then runs, by the device the planes lie on:

  * a CUDA tensor -> the hand-written kernel in ``csrc/`` (built and
    loaded by ``_build.py`` at the first use), on PyTorch's current
    stream; a failed build or launch raises — there is no fallback;
  * a CPU tensor -> the plain PyTorch version in ``ref.py``.

The sweeps update ``arr`` and ``delivered`` **in place** and return
them: the span runner owns the planes, so no ``(N, W)`` copy is made per
round (``csrc/frontier_sweep.cu`` and ``csrc/ring_apply.cu`` say why
their in-place scatter-min is safe).
Boolean inputs reach the kernels as ``uint8`` views.  ``fused_sweep``
pulls its forward through the inverse adjacency table of
:func:`inverse_table`, built on the card and cached while ``adj`` is
unchanged.

:data:`LAUNCHES` counts the kernel launches of each wrapper; it moves
only where a kernel is launched, never on the CPU path, so a run can
show that its main path went through the kernels.

The ``launch_*`` functions are the bare launches under the wrappers:
unchecked, uncounted, on outputs the caller allocates (and zeroes).
They exist so that a kernel can be timed without the wrapper's checks
and output allocations; the engines never call them.
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch

from . import _build
from . import ref as _ref

__all__ = ["LAUNCHES", "reset_launches", "fused_sweep", "deliver_sweep",
           "inverse_table", "build_inverse_table", "frontier_sweep",
           "retire_reduce", "retire_scan", "latency_hist",
           "slot_frontier", "ring_apply"]

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"fused_sweep": 0, "deliver_sweep": 0,
                            "frontier_sweep": 0, "retire_reduce": 0,
                            "retire_scan": 0, "latency_hist": 0,
                            "slot_frontier": 0, "ring_apply": 0}

# fused_sweep's forward mask: a row is whole 4-word groups, the columns
# of one warp of its plane pass (kPlaneCols in fused_sweep.cu)
_PLANE_COLS = 128
# blocks of retire_reduce aimed for when W alone gives too few
_RETIRE_TARGET_BLOCKS = 2048
_RETIRE_COLS = 128          # kRetireCols in retire_reduce.cu
# blocks of latency_hist aimed for; its column tiles are 32 wide
_HIST_TARGET_BLOCKS = 2048
_HIST_COLS = 32             # kHistCols in latency_hist.cu


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the planes on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> bool:
    """True for the kernel, False for the plain version."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"the sweep kernels run on 'cuda' or 'cpu', not "
                     f"{device.type!r}")


def _u8(x: torch.Tensor) -> int:
    """Address of a bool tensor, passed to the kernels as uint8."""
    return x.view(torch.uint8).data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch_deliver_sweep(arr, delivered, crashed, is_app, t, napp, nping):
    n, w = arr.shape
    _raise_on("deliver_sweep", _build.load_library().rt_deliver_sweep(
        arr.data_ptr(), delivered.data_ptr(), _u8(crashed), _u8(is_app),
        napp.data_ptr(), nping.data_ptr(), n, w, int(t),
        _stream(arr.device)))


def build_inverse_table(adj: torch.Tensor):
    """``(in_ptr, in_slot)`` — the in-edges of every row of the ``(N,
    K)`` table ``adj`` as CSR by target: the slots ``p * K + k`` with
    ``adj[p, k] == q`` are ``in_slot[in_ptr[q]:in_ptr[q + 1]]``, in
    increasing order, int32 on ``adj``'s device.  Targets outside ``[0,
    N)`` are dropped (``in_slot`` ends with them, past ``in_ptr[N]``);
    duplicate edges are kept.  Plain tensor operations, no host wait."""
    n, k = adj.shape
    if n * k >= 2 ** 31:
        raise ValueError(f"the inverse table indexes slots in int32: a "
                         f"({n}, {k}) table has 2^31 slots or more")
    flat = adj.reshape(-1).to(torch.int64)
    key = torch.where((flat >= 0) & (flat < n), flat, n)
    key, slot = torch.sort(key, stable=True)
    ptr = torch.searchsorted(key, torch.arange(n + 1, device=adj.device))
    return ptr.to(torch.int32), slot.to(torch.int32)


# (weak reference to the adj last seen, its version counter, its table)
_inverse = [None, -1, None]


def inverse_table(adj: torch.Tensor):
    """:func:`build_inverse_table` of ``adj``, cached for one table: built
    anew when ``adj`` is another tensor or its version counter has moved
    — every in-place write bumps it, the engine's ``adj[p, k] = q`` of a
    link addition (``sim.apply_events``) included."""
    ref, version, table = _inverse
    if ref is not None and ref() is adj and version == adj._version:
        return table
    table = build_inverse_table(adj)
    _inverse[:] = [weakref.ref(adj), adj._version, table]
    return table


def forward_mask(n: int, w: int, device) -> torch.Tensor:
    """Scratch of fused_sweep's mask of the cells delivered at ``t``:
    ``(N, 4 * ceil(W / 128))`` words (the kernel's uint32, held as
    int32), one bit a cell."""
    words = 4 * -(-w // _PLANE_COLS)
    return torch.empty((n, words), dtype=torch.int32, device=device)


def launch_fused_sweep(arr, delivered, crashed, delay, fwd_ok, is_app, t,
                       napp, nping, bits, in_ptr, in_slot, passes=3):
    """``passes=1`` runs the plane pass alone (no forward)."""
    n, w = arr.shape
    _raise_on("fused_sweep", _build.load_library().rt_fused_sweep(
        arr.data_ptr(), delivered.data_ptr(), _u8(crashed), _u8(is_app),
        delay.data_ptr(), _u8(fwd_ok), in_ptr.data_ptr(), in_slot.data_ptr(),
        bits.data_ptr(), napp.data_ptr(), nping.data_ptr(), n, w,
        delay.shape[1], int(t), int(passes), _stream(arr.device)))


def launch_frontier_sweep(arr, delivered, adj, delay, gate, do, fwd_ok,
                          is_app, t, flush_sent):
    n, w = arr.shape
    _raise_on("frontier_sweep", _build.load_library().rt_frontier_sweep(
        arr.data_ptr(), delivered.data_ptr(), adj.data_ptr(), delay.data_ptr(),
        gate.data_ptr(), _u8(do), _u8(fwd_ok), _u8(is_app),
        flush_sent.data_ptr(), n, w, adj.shape[1], int(t),
        _stream(arr.device)))


def _retire_chunks(n: int, w: int) -> int:
    """Rows a block of retire_reduce walks: enough row chunks to fill
    the card when W alone gives too few blocks, at most 65,535."""
    col_blocks = max(1, -(-w // _RETIRE_COLS))
    chunks = min(max(1, -(-_RETIRE_TARGET_BLOCKS // col_blocks)),
                 max(1, n), 65535)
    return max(1, -(-n // chunks))


def launch_retire_reduce(arr, delivered, crashed, min_gate, rounds, cnt,
                         alivedel, blocked, arrcnt, sumdel):
    n, w = arr.shape
    _raise_on("retire_reduce", _build.load_library().rt_retire_reduce(
        arr.data_ptr(), delivered.data_ptr(), _u8(crashed),
        min_gate.data_ptr(), cnt.data_ptr(), alivedel.data_ptr(),
        blocked.data_ptr(), arrcnt.data_ptr(), sumdel.data_ptr(), n, w,
        _retire_chunks(n, w), int(rounds), 1, _stream(arr.device)))


def launch_retire_scan(delivered, crashed, min_gate, cnt, alivedel,
                       blocked):
    n, w = delivered.shape
    _raise_on("retire_scan", _build.load_library().rt_retire_reduce(
        None, delivered.data_ptr(), _u8(crashed), min_gate.data_ptr(),
        cnt.data_ptr(), alivedel.data_ptr(), blocked.data_ptr(), None, None,
        n, w, _retire_chunks(n, w), 0, 0, _stream(delivered.device)))


def _hist_rows_per_chunk(n: int, ncols: int) -> int:
    """Rows of one latency_hist row chunk: enough chunks that the column
    tiles times the chunks reach ``_HIST_TARGET_BLOCKS``."""
    tiles = max(1, -(-ncols // _HIST_COLS))
    chunks = min(max(1, -(-_HIST_TARGET_BLOCKS // tiles)), max(1, n))
    return max(1, -(-n // chunks))


def launch_latency_hist(base, delivered, cols, hist):
    """``cols`` is the card's copy of the column indices, or None."""
    n, w = delivered.shape
    ncols = hist.shape[0]
    _raise_on("latency_hist", _build.load_library().rt_latency_hist(
        base.data_ptr(), delivered.data_ptr(),
        None if cols is None else cols.data_ptr(), hist.data_ptr(), n, w,
        ncols, _hist_rows_per_chunk(n, ncols), _stream(delivered.device)))


def launch_slot_frontier(delivered, gate_k, delay_k, do_k, fwd_k, is_app,
                         t, gating, vals, win_cnt):
    n, w = delivered.shape
    _raise_on("slot_frontier", _build.load_library().rt_slot_frontier(
        delivered.data_ptr(), gate_k.data_ptr(), delay_k.data_ptr(),
        _u8(do_k), _u8(fwd_k), _u8(is_app), vals.data_ptr(),
        win_cnt.data_ptr(), n, w, int(t), int(bool(gating)),
        _stream(delivered.device)))


def launch_ring_apply(dest, vals, tgt, off):
    n, w = dest.shape
    _raise_on("ring_apply", _build.load_library().rt_ring_apply(
        dest.data_ptr(), vals.data_ptr(), tgt.data_ptr(), n, w, int(off),
        _stream(dest.device)))


def _check_planes(arr, delivered, crashed, is_app):
    dev = arr.device
    n, w = arr.shape
    _check("arr", arr, torch.int32, (n, w), dev)
    _check("delivered", delivered, torch.int32, (n, w), dev)
    _check("crashed", crashed, torch.bool, (n,), dev)
    _check("is_app", is_app, torch.bool, (w,), dev)
    return dev, n, w


def _check_slots(dev, n, **tables):
    """Check the ``(N, K)`` slot tables against the first one's K."""
    first = next(iter(tables.values()))[0]
    if first.dim() != 2:
        raise ValueError(f"slot tables must be (N, K), got "
                         f"{tuple(first.shape)}")
    k = first.shape[1]
    for name, (x, dtype) in tables.items():
        _check(name, x, dtype, (n, k), dev)
    return k


def deliver_sweep(arr, delivered, crashed, is_app, t: int):
    """Phase 5 in place: ``(delivered, napp, nping)`` — ``delivered``
    updated, per-row app/ping deliveries at ``t`` (int32 ``(N,)``)."""
    dev, n, w = _check_planes(arr, delivered, crashed, is_app)
    if not _route(dev):
        d2, napp, nping = _ref.deliver_sweep_ref(arr, delivered, crashed,
                                                 is_app, t)
        delivered.copy_(d2)
        return delivered, napp, nping
    # the kernel stores every row's counts: no fill
    napp = torch.empty(n, dtype=torch.int32, device=dev)
    nping = torch.empty(n, dtype=torch.int32, device=dev)
    launch_deliver_sweep(arr, delivered, crashed, is_app, t, napp, nping)
    LAUNCHES["deliver_sweep"] += 1
    return delivered, napp, nping


def fused_sweep(arr, delivered, crashed, adj, delay, fwd_ok, is_app,
                t: int):
    """The gating-free round in place: ``(arr, delivered, napp,
    nping)`` — deliveries at ``t``, their per-row counts, and the
    forward scatter-min over ``fwd_ok`` slots into ``arr``, which the
    kernel pulls through :func:`inverse_table` of ``adj``."""
    dev, n, w = _check_planes(arr, delivered, crashed, is_app)
    _check_slots(dev, n, adj=(adj, torch.int32), delay=(delay, torch.int32),
                 fwd_ok=(fwd_ok, torch.bool))
    if not _route(dev):
        a2, d2, napp, nping = _ref.fused_sweep_ref(
            arr, delivered, crashed, adj, delay, fwd_ok, is_app, t)
        arr.copy_(a2)
        delivered.copy_(d2)
        return arr, delivered, napp, nping
    in_ptr, in_slot = inverse_table(adj)
    napp = torch.zeros(n, dtype=torch.int32, device=dev)
    nping = torch.zeros(n, dtype=torch.int32, device=dev)
    launch_fused_sweep(arr, delivered, crashed, delay, fwd_ok, is_app, t,
                       napp, nping, forward_mask(n, w, dev), in_ptr, in_slot)
    LAUNCHES["fused_sweep"] += 1
    return arr, delivered, napp, nping


def frontier_sweep(arr, delivered, adj, delay, gate, do, fwd_ok, is_app,
                   t: int):
    """The gated round's flush + forward in place: ``(arr,
    flush_sent)`` — ``do`` marks slots flushing this round, ``fwd_ok``
    slots forward-eligible; ``flush_sent`` is an int64 scalar tensor."""
    dev = arr.device
    n, w = arr.shape
    _check("arr", arr, torch.int32, (n, w), dev)
    _check("delivered", delivered, torch.int32, (n, w), dev)
    _check("is_app", is_app, torch.bool, (w,), dev)
    _check_slots(dev, n, adj=(adj, torch.int32), delay=(delay, torch.int32),
                 gate=(gate, torch.int32), do=(do, torch.bool),
                 fwd_ok=(fwd_ok, torch.bool))
    if not _route(dev):
        a2, flush_sent = _ref.frontier_sweep_ref(
            arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t)
        arr.copy_(a2)
        return arr, flush_sent
    flush_sent = torch.zeros((), dtype=torch.int64, device=dev)
    launch_frontier_sweep(arr, delivered, adj, delay, gate, do, fwd_ok,
                          is_app, t, flush_sent)
    LAUNCHES["frontier_sweep"] += 1
    return arr, flush_sent


def retire_reduce(arr, delivered, crashed, min_gate, rounds: int):
    """Per-column retirement and record reductions: ``(cnt, alivedel,
    blocked, arrcnt, sumdel)`` — four int32 ``(W,)`` and the int64
    ``(W,)`` sum of delivery rounds."""
    dev = arr.device
    n, w = arr.shape
    _check("arr", arr, torch.int32, (n, w), dev)
    _check("delivered", delivered, torch.int32, (n, w), dev)
    _check("crashed", crashed, torch.bool, (n,), dev)
    _check("min_gate", min_gate, torch.int32, (n,), dev)
    if not _route(dev):
        return _ref.retire_reduce_ref(arr, delivered, crashed, min_gate,
                                      rounds)
    outs = [torch.zeros(w, dtype=torch.int32, device=dev) for _ in range(4)]
    sumdel = torch.zeros(w, dtype=torch.int64, device=dev)
    launch_retire_reduce(arr, delivered, crashed, min_gate, rounds, *outs,
                         sumdel)
    LAUNCHES["retire_reduce"] += 1
    return (*outs, sumdel)


def retire_scan(delivered, crashed, min_gate):
    """The first three retirement reductions, ``(cnt, alivedel,
    blocked)`` — int32 ``(W,)`` — without reading ``arr``: the
    ``retire_reduce`` kernel with its record outputs switched off.  No
    engine calls it; it is the port of the JAX package's
    ``retire_scan``."""
    dev = delivered.device
    n, w = delivered.shape
    _check("delivered", delivered, torch.int32, (n, w), dev)
    _check("crashed", crashed, torch.bool, (n,), dev)
    _check("min_gate", min_gate, torch.int32, (n,), dev)
    if not _route(dev):
        return _ref.retire_scan_ref(delivered, crashed, min_gate)
    outs = [torch.zeros(w, dtype=torch.int32, device=dev) for _ in range(3)]
    launch_retire_scan(delivered, crashed, min_gate, *outs)
    LAUNCHES["retire_scan"] += 1
    return tuple(outs)


def latency_hist(base, delivered, cols=None):
    """Per-column ``(C, 32)`` int32 delivery-latency histogram: row ``p``
    of column ``j`` counts in bucket(``delivered[p, cols[j]] -
    base[j]``) when the row delivered and ``base[j] >= 0`` (the
    ``obs/hist.py`` buckets).  ``cols`` (int64 ``(C,)`` on the host)
    picks the plane's columns; it is checked against ``[0, W)`` there,
    at no wait on the card, and copied to the card, where the kernel
    reads the columns straight from the plane.  By default ``C = W`` and
    column ``j`` is plane column ``j``."""
    dev = delivered.device
    if delivered.dim() != 2:
        raise ValueError(f"delivered must be (N, W), got "
                         f"{tuple(delivered.shape)}")
    n, w = delivered.shape
    _check("delivered", delivered, torch.int32, (n, w), dev)
    c = w
    if cols is not None:
        if cols.device.type != "cpu":
            raise ValueError(f"cols must lie on the host, got {cols.device}")
        c = cols.shape[0] if cols.dim() else -1
        _check("cols", cols, torch.int64, (c,), cols.device)
        if c and not bool(((cols >= 0) & (cols < w)).all()):
            raise IndexError(f"cols must index the plane's {w} columns, "
                             f"got values in [{int(cols.min())}, "
                             f"{int(cols.max())}]")
    _check("base", base, torch.int32, (c,), dev)
    if not _route(dev):
        return _ref.latency_hist_ref(base, delivered, cols)
    hist = torch.zeros((c, _ref.NB), dtype=torch.int32, device=dev)
    if c and n:
        launch_latency_hist(base, delivered,
                            None if cols is None else cols.to(dev), hist)
        LAUNCHES["latency_hist"] += 1
    return hist


def slot_frontier(delivered, gate_k, delay_k, do_k, fwd_k, is_app, t: int,
                  gating: bool):
    """One link slot's contribution plane for the sharded ring:
    ``(vals, win_cnt)`` — int32 ``(N, W)`` plane, ``t + delay_k`` where
    the row forwards (``fwd_k``) a delivery of round ``t`` or, with
    ``gating``, flushes (``do_k``) an app column delivered in ``[gate_k,
    t)``, INF elsewhere; and the int32 count of flushed cells."""
    dev = delivered.device
    if delivered.dim() != 2:
        raise ValueError(f"delivered must be (N, W), got "
                         f"{tuple(delivered.shape)}")
    n, w = delivered.shape
    _check("delivered", delivered, torch.int32, (n, w), dev)
    for name, x, dtype in (("gate_k", gate_k, torch.int32),
                           ("delay_k", delay_k, torch.int32),
                           ("do_k", do_k, torch.bool),
                           ("fwd_k", fwd_k, torch.bool)):
        _check(name, x, dtype, (n,), dev)
    _check("is_app", is_app, torch.bool, (w,), dev)
    if n * w >= 2 ** 31:
        raise ValueError(f"slot_frontier counts in int32: a ({n}, {w}) "
                         "plane has 2^31 cells or more")
    if not _route(dev):
        return _ref.slot_frontier_ref(delivered, gate_k, delay_k, do_k,
                                      fwd_k, is_app, t, gating)
    vals = torch.empty((n, w), dtype=torch.int32, device=dev)
    win_cnt = torch.zeros((), dtype=torch.int32, device=dev)
    launch_slot_frontier(delivered, gate_k, delay_k, do_k, fwd_k, is_app, t,
                         gating, vals, win_cnt)
    LAUNCHES["slot_frontier"] += 1
    return vals, win_cnt


def ring_apply(dest, vals, tgt, off: int):
    """One ring hop in place: ``dest`` — the rows of ``vals`` whose
    global target ``tgt[p]`` lies in ``[off, off + N)`` scatter-min into
    row ``tgt[p] - off`` of ``dest``; the others are dropped."""
    dev = dest.device
    if dest.dim() != 2:
        raise ValueError(f"dest must be (N, W), got {tuple(dest.shape)}")
    n, w = dest.shape
    _check("dest", dest, torch.int32, (n, w), dev)
    _check("vals", vals, torch.int32, (n, w), dev)
    _check("tgt", tgt, torch.int32, (n,), dev)
    if not _route(dev):
        dest.copy_(_ref.ring_apply_ref(dest, vals, tgt, off))
        return dest
    launch_ring_apply(dest, vals, tgt, off)
    LAUNCHES["ring_apply"] += 1
    return dest
