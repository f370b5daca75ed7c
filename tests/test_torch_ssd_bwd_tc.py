"""The arithmetic of ``ssd_scan_bwd``'s tensor-core body on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``, the
launches of ``launch_ssd_bwd_mma``) runs only on the card.  For bf16
inputs with chunks and N of at most 128 it runs every product on bf16
tensor cores accumulating in f32, with Q and N zero-padded to 128 and P
to tiles of 64.  An operand that is a bf16 input goes in as it is; an
operand that is an f32 intermediate goes in as a bf16 hi/lo split
(``a = hi + lo``, ``hi = bf16(a)``, ``lo = bf16(a - hi)``): the weighted
``w X`` and ``e^l dY`` of the chunk states (step 2'), ``M = CB o L`` in
``M^T dY`` and the states ``dH`` and ``H_prev`` (step 6'), ``S`` and the
states again (step 8').  ``diag(w)`` and ``diag(e^l)`` that scale an
output's rows are applied after the product.  dCB is summed over groups
of 8 heads in head order (step 5') and ``S`` over the groups in group
order (step 8'), as are the groups' partials of dB and dC (step 9).

This file keeps a plain mirror of that order of work (``.bfloat16()``
casts for the splits, f32 products, the padding, the P tiles of the
partial sums) and holds it against the plain backward
``ssd_chunk_scan_bwd_ref`` that the kernel is held to on the card,
against float64 autograd through ``ssd_chunk_scan_ref`` (no further than
1.5 times the plain backward's own distance: both round dX, dB and dC
to bf16), and at one shape against ``jax.vjp`` of the JAX package's
reference.  One bf16 rounding of M or S in place of the split lands an
order of magnitude further from float64 before the outputs' rounding.

The mirror's comments name the kernel's steps (``1'`` to ``9``); its
tile, P tile and head group are ``kMmaTile``, ``kMmaPt`` and
``kHeadsPerGroup``: a change to one of those in the kernel needs the
same change here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.ssm import ssd_chunk_scan_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan.ref import (chunk_len,
                                              ssd_chunk_scan_bwd_ref,
                                              ssd_chunk_scan_ref)

TOL = 2e-2            # bf16, of each gradient's largest entry
LOG2E = 1.4426950408889634
TILE = 128            # kMmaTile: Q and N, zero-padded
PT = 64               # kMmaPt: the P tile
GROUP = 8             # kHeadsPerGroup


def _split(a):
    """f32 -> (hi, lo), each a bf16 value held in f32."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _left(a, b, split=True):
    """a @ b with the f32 ``a`` split (or rounded once), ``b`` bf16."""
    if not split:
        return a.bfloat16().float() @ b
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _right(a, b):
    """a @ b with ``a`` bf16 and the f32 ``b`` split."""
    hi, lo = _split(b)
    return a @ hi + a @ lo


def _tile(t, b, nc, q, s):
    """(B, S, ...) -> (B, NC, TILE, ...): S padded to whole chunks, each
    chunk's rows zero-padded to the tile."""
    t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, nc * q - s))
    t = t.reshape(b, nc, q, *t.shape[2:])
    return F.pad(t, (0, 0) * (t.dim() - 3) + (0, TILE - q))


def mma_bwd_mirror(xbar, a_log, Bm, Cm, dy, dh, chunk=128, split_ms=True):
    """bf16 inputs -> ((dx, da, dB, dC) as the kernel returns them, the
    same before dX, dB and dC are rounded to bf16), in the kernel's order
    of work.  ``split_ms=False`` rounds M and S to bf16 once instead of
    splitting them."""
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    q = chunk_len(s, chunk)
    assert q <= TILE and n <= TILE and xbar.dtype == torch.bfloat16
    nc = -(-s // q)
    tp = -(-p // PT)
    # zero padding: S to whole chunks, Q and N to the tile, P to whole
    # P tiles (a ragged last one)
    x = F.pad(_tile(xbar, b, nc, q, s), (0, tp * PT - p)).transpose(2, 3)
    gy = F.pad(_tile(dy, b, nc, q, s), (0, tp * PT - p)).transpose(2, 3)
    bt = F.pad(_tile(Bm, b, nc, q, s), (0, TILE - n))[:, :, None]
    ct = F.pad(_tile(Cm, b, nc, q, s), (0, TILE - n))[:, :, None]
    al = F.pad(a_log, (0, 0, 0, nc * q - s)).reshape(b, nc, q, h)
    real = torch.arange(TILE) < q
    tri = torch.tril(torch.ones((TILE, TILE), dtype=torch.bool)) & real[:, None]

    # 1'. l, e^l and w of the chunk's steps (zero past q)
    l = torch.cumsum(al.transpose(2, 3), -1)            # (b, nc, h, q)
    lq = l[..., -1:]
    el = F.pad(torch.exp(l), (0, TILE - q))
    w = F.pad(torch.exp(lq - l), (0, TILE - q))
    l2 = F.pad(l * LOG2E, (0, TILE - q))
    # 2'. each chunk's own state terms: B^T diag(w) X and C^T diag(e^l)
    # dY, the weighted operand split
    hs = _right(bt.transpose(-1, -2), w[..., None] * x)
    gs = _right(ct.transpose(-1, -2), el[..., None] * gy)
    # 3. the state walks in f32: H_prev forward, dH back from dh
    dec = torch.exp(lq)[..., None]                       # (b, nc, h, 1, 1)
    run = torch.zeros((b, h, TILE, tp * PT))
    hp = []
    for c in range(nc):
        hp.append(run)
        run = run * dec[:, c] + hs[:, c]
    run = F.pad(dh.float(), (0, tp * PT - p, 0, TILE - n))
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = run
        run = run * dec[:, c] + gs[:, c]
    hp, dhs = torch.stack(hp, 1), torch.stack(dhs, 1)
    hd = (hp * dhs).sum((-2, -1))                        # (b, nc, h)
    # 4'. CB = C B^T: exact products of bf16 values, f32 sums
    cb = torch.where(tri, ct @ bt.transpose(-1, -2), 0.0)
    # 5'. each head's dY X^T (bf16 as they are) on j <= i, dCB = that o
    # L masked before exp; G = dCB o CB summed along rows and columns;
    # dCB summed over each group's heads in order
    lp = F.pad(l, (0, TILE - q))
    seg = torch.where(tri, (lp[..., :, None] - lp[..., None, :]) * LOG2E,
                      torch.tensor(-float("inf")))
    dcb = torch.where(tri, (gy @ x.transpose(-1, -2)) * torch.exp2(seg), 0.0)
    g_ = dcb * cb
    rowg, colg = g_.sum(-1), g_.sum(-2)
    groups = -(-h // GROUP)
    sp = []
    for grp in range(groups):
        acc = torch.zeros_like(dcb[:, :, 0])
        for hh in range(grp * GROUP, min(h, grp * GROUP + GROUP)):
            acc = acc + dcb[:, :, hh]
        sp.append(acc)
    # 6'. dX = M^T dY + diag(w) B dH: M = CB o L (exp2 of l log2(e))
    # split (as A), dY as it is; B as it is and dH split, diag(w) after
    # the product; r summed over each P tile
    m = cb * torch.exp2(torch.where(tri, l2[..., :, None] - l2[..., None, :],
                                    torch.tensor(-float("inf"))))
    a1 = _left(m.transpose(-1, -2), gy, split_ms)
    a2 = _right(bt, dhs)
    dx32 = a1 + w[..., None] * a2
    r = (w[..., None] * x * a2).reshape(b, nc, h, TILE, tp, PT).sum(-1)
    # 8'. S = the groups' dCB summed in group order; group 0 adds S B
    # (dC) and S^T C (dB) with S split; each head adds its dY H_prev^T
    # (X dH^T), the state split, times diag(e^l) (diag(w)) after the
    # product, in head order; e^l <dY, C H_prev> = the rows of C o (e^l
    # dY H_prev^T) summed over each N tile
    s_sum = sp[0]
    for part in sp[1:]:
        s_sum = s_sum + part
    pc, pb = [], []
    ip = torch.zeros((b, nc, h, TILE, TILE // PT))
    for grp in range(groups):
        if grp == 0:
            acc_c = _left(s_sum, bt[:, :, 0], split_ms)
            acc_b = _left(s_sum.transpose(-1, -2), ct[:, :, 0], split_ms)
        else:
            acc_c = acc_b = torch.zeros((b, nc, TILE, TILE))
        for hh in range(grp * GROUP, min(h, grp * GROUP + GROUP)):
            head_c = el[:, :, hh, :, None] * _right(
                gy[:, :, hh], hp[:, :, hh].transpose(-1, -2))
            ip[:, :, hh] = (ct[:, :, 0] * head_c).reshape(
                b, nc, TILE, TILE // PT, PT).sum(-1)
            acc_c = acc_c + head_c
            acc_b = acc_b + w[:, :, hh, :, None] * _right(
                x[:, :, hh], dhs[:, :, hh].transpose(-1, -2))
        pc.append(acc_c)
        pb.append(acc_b)
    # 7'. dl, then da its reverse cumsum within the chunk
    dl = rowg - colg + ip.sum(-1) - r.sum(-1)
    dl[..., q - 1] += el[..., q - 1] * hd + r.sum((-2, -1))
    da = dl[..., :q].flip(-1).cumsum(-1).flip(-1)
    # 9. the groups' partials summed in order
    dc32, db32 = pc[0], pb[0]
    for c_, b_ in zip(pc[1:], pb[1:]):
        dc32, db32 = dc32 + c_, db32 + b_

    def rows(t, cols):          # (b, nc, TILE, cols) -> (b, s, cols)
        return t[:, :, :q, :cols].reshape(b, nc * q, cols)[:, :s]
    dx32 = dx32[..., :q, :p].transpose(2, 3).reshape(b, nc * q, h, p)[:, :s]
    da = da.transpose(2, 3).reshape(b, nc * q, h)[:, :s]
    f32 = (dx32, da, rows(db32, n), rows(dc32, n))
    return (f32[0].bfloat16(), da, f32[2].bfloat16(), f32[3].bfloat16()), f32


def _inputs(rng, b, s, h, p, n):
    """bf16 x, B, C and dy, f32 a_log and dh, as chip_smoke.py makes
    them, from numpy."""
    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return (bf(rng.standard_normal((b, s, h, p)) * 0.5),
            torch.from_numpy(-np.logaddexp(rng.standard_normal((b, s, h)),
                                           0).astype(np.float32)),
            bf(rng.standard_normal((b, s, n)) * 0.3),
            bf(rng.standard_normal((b, s, n)) * 0.3),
            bf(rng.standard_normal((b, s, h, p))),
            torch.from_numpy(rng.standard_normal((b, h, n, p)).astype(
                np.float32)))


def _frac(got, want):
    """Largest |got - want| of each gradient over its largest |want|,
    the worst of the four."""
    return max(float((g.double() - w.double()).abs().max()
                     / w.double().abs().max()) for g, w in zip(got, want))


def _float64(x, al, bm, cm, dy, dh, chunk):
    wide = [t.double().requires_grad_() for t in (x, al, bm, cm)]
    return torch.autograd.grad(ssd_chunk_scan_ref(*wide, chunk=chunk), wide,
                               (dy.double(), dh.double()))


# q = S < chunk, a tiny chunk walk, the full tile with a padded last
# chunk, q = S of 40 steps, P and N not multiples of 8, 10 heads (two
# head groups, the last of 2) over a padded chunk, P of 80 (two P tiles,
# the last ragged), a ragged P tile of 48 at batch 2, and the main path's
# 80 heads (ten groups) over one chunk
SHAPES = [(1, 5, 2, 16, 16, 16), (1, 64, 1, 8, 16, 16),
          (1, 300, 4, 64, 128, 128), (1, 40, 5, 8, 16, 64),
          (1, 100, 3, 12, 24, 128), (1, 36, 10, 8, 16, 16),
          (1, 40, 2, 80, 16, 64), (2, 96, 3, 48, 32, 32),
          (1, 128, 80, 64, 128, 128)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_mirror_matches_plain_and_float64(b, s, h, p, n, chunk):
    rng = np.random.default_rng(3000 + s + h + p + n)
    args = _inputs(rng, b, s, h, p, n)
    got, _ = mma_bwd_mirror(*args, chunk=chunk)
    want = ssd_chunk_scan_bwd_ref(*args, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g).all())
    # the plain backward the kernel is held to on the card
    assert _frac(got, want) <= TOL
    # float64: no further than the plain backward (both round dX, dB, dC)
    truth = _float64(*args, chunk)
    assert _frac(got, truth) <= 1.5 * _frac(want, truth)


def test_mirror_matches_jax_vjp():
    """The JAX package's reference, at f32 on the same bf16 values."""
    b, s, h, p, n, chunk = 1, 100, 10, 16, 32, 32
    rng = np.random.default_rng(11)
    args = _inputs(rng, b, s, h, p, n)
    got, _ = mma_bwd_mirror(*args, chunk=chunk)
    npy = [t.float().numpy() for t in args]

    @jax.jit
    def vjp(primals, cot):
        return jax.vjp(lambda *a: jax_ssd_ref(*a, chunk=chunk),
                       *primals)[1](cot)
    want = vjp(tuple(jnp.asarray(a) for a in npy[:4]),
               (jnp.asarray(npy[4]), jnp.asarray(npy[5])))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.float().numpy() - w).max()) <= \
            TOL * float(np.abs(w).max())


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 300, 4, 64, 128, 128),
                                             (1, 36, 10, 8, 16, 16)])
def test_split_m_and_s_are_closer_to_float64_than_one_rounding(b, s, h, p,
                                                               n, chunk):
    """Before the outputs' bf16 rounding, the split keeps M (in dX) and S
    (in dB and dC) to about 16 bits and one bf16 rounding to 8: the
    latter lands an order of magnitude further from float64."""
    rng = np.random.default_rng(5000 + s)
    args = _inputs(rng, b, s, h, p, n)
    truth = _float64(*args, chunk)
    _, split = mma_bwd_mirror(*args, chunk=chunk)
    _, once = mma_bwd_mirror(*args, chunk=chunk, split_ms=False)
    for k in (0, 2, 3):                  # dX (M), dB and dC (S)
        err_split = _frac([split[k]], [truth[k]])
        err_once = _frac([once[k]], [truth[k]])
        assert err_once > 10 * err_split, (k, err_once, err_split)
