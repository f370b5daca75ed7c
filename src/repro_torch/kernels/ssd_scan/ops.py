"""Wrapper of the chunked SSD scan kernel (``csrc/ssd_scan.cu``), with
the contract of the JAX package's ``ssd_chunk_scan`` op: the same
inputs and outputs, chunk padding included.

The kernel reads the op's own layouts — xbar (B, S, H, P), a_log (B, S,
H), Bm and Cm (B, S, N) — so no transposed copy is made: a block finds
its head's rows (and its slice of P) by stride, and B and C by batch
row (shared by the heads, n_groups = 1).  bf16 chunks of at most 128
steps and states of at most 128 rows run on the tensor cores, the rest
on the CUDA cores (:func:`ssd_scan_body`).

On CUDA tensors that need a gradient the launch is wrapped in an
autograd function whose backward is a kernel of its own
(``csrc/ssd_scan_bwd.cu``, counted under ``ssd_scan_bwd``): the SSD
backward does not reduce to this forward kernel (dB and dC sum over the
heads products of dy with x, which its shared (B, S, N) Bm and Cm cannot
express), so it recomputes the chunk states from the saved inputs and
computes the four gradients by the formulas of
``ssd_chunk_scan_bwd_ref``; nothing beyond the inputs is saved.  Its
products run on the tensor cores for the shapes the forward's do (bf16,
chunks and N of at most 128; f32 operands split into bf16 hi and lo
parts) and on the CUDA cores otherwise (:func:`ssd_scan_bwd_body`).
With no gradient wanted (serving's prefill) the launch runs bare.  On
the CPU the plain version is ordinary differentiable torch code.

On ``meta`` tensors the launch, and its backward, only allocate, counted
by the dry-run as the roofline's SSD term, 2 B S (q N + H q P + 2 H N P)
flops a forward and twice that a backward.  A DTensor reaches the
kernel as its local shard with the batch and heads sharded at most (B
and C are shared by the heads, so they keep the batch sharding only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import common
from .ref import chunk_len, ssd_chunk_scan_ref

__all__ = ["ssd_chunk_scan", "launch_ssd_scan", "launch_ssd_scan_bwd",
           "ssd_scan_body", "ssd_scan_bwd_body"]

# rt_ssd_scan_body's and rt_ssd_scan_bwd_body's codes (csrc/ssd_scan.cu,
# csrc/ssd_scan_bwd.cu)
_BODIES = {0: "fma", 1: "mma"}


def ssd_scan_body(q: int, n: int, dtype: torch.dtype) -> str:
    """The body the kernel runs for chunks of ``q`` steps, N = ``n`` and
    inputs of ``dtype``: ``"mma"`` (tensor cores, bf16 with q and n at
    most 128) or ``"fma"`` (CUDA cores).  Asks the built library, so it
    needs the CUDA toolchain."""
    return _BODIES[common.library().rt_ssd_scan_body(
        q, n, common.DTYPE_CODE[dtype])]


def ssd_scan_bwd_body(q: int, n: int, dtype: torch.dtype) -> str:
    """The body the backward kernel runs for the same shape: ``"mma"``
    or ``"fma"`` by :func:`ssd_scan_body`'s rule.  Asks the built
    library."""
    return _BODIES[common.library().rt_ssd_scan_bwd_body(
        q, n, common.DTYPE_CODE[dtype])]


def launch_ssd_scan(xbar, a_log, Bm, Cm, y, hout, q: int):
    """The bare launch on padded inputs (S a multiple of ``q``): unchecked,
    uncounted, into ``y`` (B, S, H, P) and ``hout`` (B, H, N, P) f32."""
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    common.raise_on("ssd_scan", common.library().rt_ssd_scan(
        xbar.data_ptr(), a_log.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), hout.data_ptr(), b, s // q, q, h, p, n,
        common.DTYPE_CODE[xbar.dtype], common.stream(xbar.device)))


def launch_ssd_scan_bwd(xbar, a_log, Bm, Cm, dy, dh, dx, da, dB, dC, q: int):
    """The bare backward launch on padded inputs (S a multiple of ``q``):
    unchecked, uncounted, into ``dx`` (as xbar), ``da`` (as a_log, f32),
    ``dB`` and ``dC`` (as Bm); ``dy`` as xbar, ``dh`` (B, H, N, P) f32.
    Allocates the kernel's f32 scratch (``rt_ssd_scan_bwd_scratch``
    words), freed on return: the caching allocator hands it out again
    only behind the launch on the same stream."""
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    lib = common.library()
    words = lib.rt_ssd_scan_bwd_scratch(b, s // q, q, h, p, n,
                                        common.DTYPE_CODE[xbar.dtype])
    if words < 0:
        raise ValueError(f"ssd_scan_bwd: {tuple(xbar.shape)} with N={n} "
                         f"needs a scratch of 2^31 words or more")
    scratch = torch.empty(words, dtype=torch.float32, device=xbar.device)
    common.raise_on("ssd_scan_bwd", lib.rt_ssd_scan_bwd(
        xbar.data_ptr(), a_log.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dy.data_ptr(), dh.data_ptr(), dx.data_ptr(), da.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(), b, s // q, q, h,
        p, n, common.DTYPE_CODE[xbar.dtype], common.stream(xbar.device)))


def _flops(xbar, n: int, chunk: int) -> int:
    """The roofline's forward flops of one SSD layer on these inputs."""
    b, s, h, p = xbar.shape
    q = chunk_len(s, chunk)
    return 2 * b * s * (q * n + h * q * p + 2 * h * n * p)


def _pad_chunks(q: int, *ts):
    """Each of ``ts`` zero-padded along S (dim 1) to a multiple of ``q``."""
    pad = (-ts[0].shape[1]) % q
    if not pad:
        return ts
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)


def _scan(xbar, a_log, Bm, Cm, chunk: int):
    """The kernel on checked CUDA tensors: pad S to the chunk, launch
    (counted), drop the padded rows; on meta tensors the outputs alone."""
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    if xbar.device.type == "meta":
        return (common.meta_out(xbar, [b, s, h, p], xbar.dtype,
                                _flops(xbar, n, chunk)),
                common.meta_out(xbar, [b, h, n, p], torch.float32, 0))
    q = chunk_len(s, chunk)
    xbar, a_log, Bm, Cm = _pad_chunks(q, xbar, a_log, Bm, Cm)
    y = torch.empty_like(xbar)
    hout = torch.empty((b, h, n, p), dtype=torch.float32,
                       device=xbar.device)
    launch_ssd_scan(xbar, a_log, Bm, Cm, y, hout, q)
    common.LAUNCHES["ssd_scan"] += 1
    return y[:, :s], hout


def _scan_bwd(xbar, a_log, Bm, Cm, dy, dh, chunk: int):
    """The backward kernel on the forward's CUDA tensors and the output
    gradients: pad S to the chunk (dy with zeros), launch (one count a
    call), drop the padded rows.  Returns (dxbar, da_log, dBm, dCm)."""
    s = xbar.shape[1]
    q = chunk_len(s, chunk)
    xbar, a_log, Bm, Cm, dy = _pad_chunks(q, xbar, a_log, Bm, Cm,
                                          dy.contiguous())
    outs = [torch.empty_like(t) for t in (xbar, a_log, Bm, Cm)]
    launch_ssd_scan_bwd(xbar, a_log, Bm, Cm, dy, dh.contiguous(), *outs, q)
    common.LAUNCHES["ssd_scan_bwd"] += 1
    return tuple(t[:, :s] for t in outs)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xbar, a_log, Bm, Cm, chunk):
        ctx.save_for_backward(xbar, a_log, Bm, Cm)
        ctx.chunk = chunk
        return _scan(xbar, a_log, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        if dy.device.type == "meta":
            flops = [2 * _flops(saved[0], saved[2].shape[-1], ctx.chunk)]
            return (*(common.meta_out(t, list(t.shape), t.dtype,
                                      flops.pop() if flops else 0)
                      if need else None
                      for t, need in zip(saved, ctx.needs_input_grad)),
                    None)
        grads = _scan_bwd(*saved, dy, dh, ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd_chunk_scan(xbar, a_log, Bm, Cm, chunk: int = 128):
    """xbar (B,S,H,P) float32 or bfloat16; a_log (B,S,H) float32; Bm, Cm
    (B,S,N) of xbar's type -> (y (B,S,H,P) of xbar's type, h_final
    (B,H,N,P) float32).  The kernel on CUDA tensors, the plain version on
    CPU tensors; differentiable (on the card the backward is the
    ``ssd_scan_bwd`` kernel).  DTensors run on their local shards."""
    if common.is_dtensor(xbar):
        heads = {0: 0, 2: 2}
        return common.local_call(
            lambda x_, a_, b_, c_: ssd_chunk_scan(
                x_.contiguous(), a_.contiguous(), b_.contiguous(),
                c_.contiguous(), chunk),
            (xbar, a_log, Bm, Cm), (heads, heads, {0: 0}, {0: 0}),
            (heads, {0: 0, 2: 1}))
    if xbar.dim() != 4:
        raise ValueError(f"xbar must be (B, S, H, P), got "
                         f"{tuple(xbar.shape)}")
    dev = xbar.device
    b, s, h, p = xbar.shape
    common.check("xbar", xbar, (b, s, h, p), dev)
    common.check("a_log", a_log, (b, s, h), dev, torch.float32)
    n = Bm.shape[-1] if Bm.dim() == 3 else -1
    common.check("Bm", Bm, (b, s, n), dev, xbar.dtype)
    common.check("Cm", Cm, (b, s, n), dev, xbar.dtype)
    if not common.route(dev):
        return ssd_chunk_scan_ref(xbar, a_log, Bm, Cm, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbar, a_log, Bm, Cm)):
        return _SSDScan.apply(xbar, a_log, Bm, Cm, chunk)
    # no gradient wanted: the bare launch, without an autograd node's
    # host cost
    return _scan(xbar, a_log, Bm, Cm, chunk)
