"""Plain PyTorch versions of the delivery-sweep, retirement,
latency-histogram and sharded-exchange kernels, and the frontier
bit-plane helpers of the sharded fast body.

Each function states, in ordinary tensor operations, what the CUDA
kernel of the same name in ``csrc/`` computes (``retire_scan`` is the
``retire_reduce`` kernel with its record outputs off) — same inputs, same
outputs — and is the counterpart of the JAX package's
``repro.core.vecsim.kernels.ref``.  The wrappers in ``ops.py`` run these
for tensors on the CPU; ``chip_smoke.py`` holds each kernel against its
plain version on the card.  They are functional (inputs are never
written) and are no yardstick of speed.

Scatter-min targets outside ``[0, N)`` are dropped, as ``mode="drop"``
does in the JAX references.  Every scattered value is ``t + delay``
with ``delay >= 1``, and int32 min commutes, so the result does not
depend on the order of the scatter.
"""

from __future__ import annotations

import torch

from ....obs.hist import NB, bucket_index_torch
from ..scenario import INF

__all__ = ["deliver_sweep_ref", "fused_sweep_ref", "frontier_sweep_ref",
           "retire_scan_ref", "retire_reduce_ref", "NB", "latency_hist_ref",
           "slot_frontier_ref", "ring_apply_ref", "pack_columns",
           "unpack_columns", "popcount_bytes"]

_INF = int(INF)


def _scatter_min(arr: torch.Tensor, send: torch.Tensor, tgt: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """In place: ``arr[tgt[p], m] = min(arr[tgt[p], m], vals[p])`` for
    every ``send[p, m]`` with ``tgt[p]`` in ``[0, N)``."""
    n, w = arr.shape
    rows, cols = torch.nonzero(send, as_tuple=True)
    q = tgt[rows].long()
    ok = (q >= 0) & (q < n)
    lin = q[ok] * w + cols[ok]
    arr.view(-1).scatter_reduce_(0, lin, vals[rows][ok], reduce="amin")


def deliver_sweep_ref(arr, delivered, crashed, is_app, t: int):
    """(delivered', napp, nping) — phase 5 (arrivals at ``t`` deliver
    unless already delivered or crashed) plus this round's per-row app
    and ping delivery counts (int32)."""
    newly = (arr == t) & (delivered < 0) & ~crashed[:, None]
    delivered = delivered.masked_fill(newly, t)
    new_del = delivered == t
    napp = (new_del & is_app[None, :]).sum(dim=1, dtype=torch.int32)
    nping = (new_del & ~is_app[None, :]).sum(dim=1, dtype=torch.int32)
    return delivered, napp, nping


def fused_sweep_ref(arr, delivered, crashed, adj, delay, fwd_ok, is_app,
                    t: int):
    """(arr', delivered', napp, nping) — the gating-free round: deliver,
    count, and for every cell ``(p, m)`` delivered at ``t`` scatter-min
    ``t + delay[p, k]`` into cell ``(adj[p, k], m)`` over the
    forward-eligible slots ``k``."""
    delivered, napp, nping = deliver_sweep_ref(arr, delivered, crashed,
                                               is_app, t)
    new_del = delivered == t
    arr = arr.clone()
    for kk in range(adj.shape[1]):
        _scatter_min(arr, new_del & fwd_ok[:, kk, None], adj[:, kk],
                     (t + delay[:, kk]).to(torch.int32))
    return arr, delivered, napp, nping


def frontier_sweep_ref(arr, delivered, adj, delay, gate, do, fwd_ok,
                       is_app, t: int):
    """(arr', flush_sent) — the gated round's phases 7 + 8 over
    post-delivery ``delivered``: on slots flushing this round (``do``),
    app columns delivered in ``[gate, t)`` are re-sent; on
    forward-eligible slots, columns delivered at ``t`` are forwarded;
    both go out in one scatter-min.  ``flush_sent`` (int64) counts the
    flushed (row, slot, column) sends."""
    new_del = delivered == t
    arr = arr.clone()
    flush_sent = torch.zeros((), dtype=torch.int64, device=arr.device)
    for kk in range(adj.shape[1]):
        win = ((delivered >= gate[:, kk, None]) & (delivered < t)
               & do[:, kk, None] & is_app[None, :])
        flush_sent += win.sum()
        _scatter_min(arr, (new_del & fwd_ok[:, kk, None]) | win,
                     adj[:, kk], (t + delay[:, kk]).to(torch.int32))
    return arr, flush_sent


def retire_scan_ref(delivered, crashed, min_gate):
    """(cnt, alivedel, blocked) per column, int32: the first three
    outputs of :func:`retire_reduce_ref`, without reading ``arr``."""
    got = delivered >= 0
    cnt = got.sum(dim=0, dtype=torch.int32)
    alivedel = (got & ~crashed[:, None]).sum(dim=0, dtype=torch.int32)
    blocked = (got & (delivered >= min_gate[:, None])).sum(
        dim=0, dtype=torch.int32)
    return cnt, alivedel, blocked


def retire_reduce_ref(arr, delivered, crashed, min_gate, rounds: int):
    """(cnt, alivedel, blocked, arrcnt, sumdel) per column: deliveries,
    deliveries by alive rows, deliveries at or after the row's earliest
    open gate, first receipts (``arr < rounds``), all int32, and the sum
    of delivery rounds (int64)."""
    cnt, alivedel, blocked = retire_scan_ref(delivered, crashed, min_gate)
    arrcnt = (arr < rounds).sum(dim=0, dtype=torch.int32)
    sumdel = torch.where(delivered >= 0, delivered, 0).sum(
        dim=0, dtype=torch.int64)
    return cnt, alivedel, blocked, arrcnt, sumdel


def latency_hist_ref(base, delivered, cols=None):
    """``(C, 32)`` int32 per-column latency histogram: row ``p`` of
    column ``j`` counts in bucket ``bucket_index_torch(delivered[p, m] -
    base[j])`` (the 15 comparisons of the TPU kernel, not the CUDA
    kernel's ``31 - __clz``) where ``delivered[p, m] >= 0`` and
    ``base[j] >= 0``; ``m`` is ``cols[j]`` (int64 indices into the
    plane's columns, on any device) or ``j`` when ``cols`` is None."""
    d = (delivered if cols is None
         else delivered.index_select(1, cols.to(delivered.device)))
    c = d.shape[1]
    valid = (d >= 0) & (base >= 0)[None, :]
    bucket = bucket_index_torch(d.to(torch.int64)
                                - base.to(torch.int64)[None, :])
    flat = (torch.arange(c, device=d.device)[None, :] * NB + bucket)[valid]
    return torch.bincount(flat, minlength=c * NB).view(c, NB).to(
        torch.int32)


def slot_frontier_ref(delivered, gate_k, delay_k, do_k, fwd_k, is_app,
                      t: int, gating: bool):
    """(vals, win_cnt) — one link slot's contribution plane for the
    sharded ring: ``t + delay_k`` where the row forwards (``fwd_k``) a
    delivery of round ``t`` or, with ``gating``, flushes (``do_k``) an
    app column delivered in ``[gate_k, t)``; INF elsewhere.  ``win_cnt``
    (int32 scalar) counts the flushed cells."""
    dk = (t + delay_k).to(torch.int32)[:, None]
    send = (delivered == t) & fwd_k[:, None]
    win_cnt = torch.zeros((), dtype=torch.int32, device=delivered.device)
    if gating:
        win = ((delivered >= gate_k[:, None]) & (delivered < t)
               & do_k[:, None] & is_app[None, :])
        send = send | win
        win_cnt = win.sum(dtype=torch.int32)
    inf = torch.full_like(delivered, _INF)
    return torch.where(send, dk.expand_as(delivered), inf), win_cnt


def ring_apply_ref(dest, vals, tgt, off: int):
    """dest' — one ring hop: the rows of ``vals`` whose global target
    ``tgt[p]`` lies in ``[off, off + n_loc)`` scatter-min into row
    ``tgt[p] - off`` of a copy of ``dest``; the others are dropped."""
    n_loc, w = dest.shape
    tl = tgt.to(torch.int64) - off
    local = (tl >= 0) & (tl < n_loc)
    idx = tl[local][:, None].expand(-1, w)
    return dest.clone().scatter_reduce_(0, idx, vals[local], reduce="amin")


# ------------------------------------------------------------------------- #
# Frontier bit planes (the sharded fast body): plain tensor operations in
# every route, like their JAX counterparts, which are lax and not Pallas.
# Bit order is little-endian within a byte, as np.packbits(...,
# bitorder="little") packs it.
# ------------------------------------------------------------------------- #
def _bit_shifts(device) -> torch.Tensor:
    # built on the device (no host-to-card copy, so no wait on the card)
    one = torch.ones(8, dtype=torch.uint8, device=device)
    return one << torch.arange(8, dtype=torch.uint8, device=device)


def pack_columns(b: torch.Tensor) -> torch.Tensor:
    """Bit-pack an ``(N, W)`` bool plane into ``(N, ceil(W/8))`` uint8;
    the ragged tail bits are zero."""
    n, w = b.shape
    wp = -(-max(w, 1) // 8)
    if wp * 8 != w:
        b = torch.cat([b, b.new_zeros((n, wp * 8 - w))], dim=1)
    bits = b.view(n, wp, 8).to(torch.uint8) * _bit_shifts(b.device)
    return bits.sum(dim=2, dtype=torch.uint8)


def unpack_columns(p: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of :func:`pack_columns`: ``(N, Wp)`` uint8 back to the
    ``(N, w)`` bool plane."""
    n, wp = p.shape
    b = (p[:, :, None] & _bit_shifts(p.device)) != 0
    return b.view(n, wp * 8)[:, :w]


def popcount_bytes(x: torch.Tensor) -> torch.Tensor:
    """Per-byte SWAR popcount of a uint8 tensor (three shift/mask
    rounds)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F
