"""The arithmetic of ``ssd_scan``'s tensor-core body on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``,
``ssd_scan_mma_kernel``) runs only on the card.  For bf16 inputs it
walks each (batch, head, slice of P) through the chunks in order, with
every product on bf16 tensor cores accumulating in f32.  The operands
that are f32 intermediates go in as a bf16 hi/lo split (``a = hi +
lo``, ``hi = bf16(a)``, ``lo = bf16(a - hi)``): the masked,
decay-weighted ``att``, the state ``H`` in ``C H``, and the weighted
``exp(l_{Q-1} - l_j) x_j`` in the state update.  This file keeps a plain
mirror of that arithmetic (slices, zero padding of Q and N to the
128 x 128 tile, the chunk walk, ``.bfloat16()`` casts for the splits,
f32 products) and
holds it against the plain version ``ssd_chunk_scan_ref`` the kernel is
held to on the card (itself held to the JAX package's op by
``test_torch_lm_kernels.py``) and a float64 evaluation: within a fifth
of the bf16 tolerance of float64, where a single bf16 rounding of
``att`` (the JAX reference's) is further away.

The mirror's comments name the numbered steps of ``ssd_scan_mma_kernel``
(``// 1.`` to ``// 5.`` in the kernel's chunk loop), and its slice width
and tile size are ``rt_ssd_scan``'s and ``kSsdTile``: a change to one of
those in the kernel needs the same change here.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan.ref import chunk_len, ssd_chunk_scan_ref

TOL = 2e-2            # bf16, as tests/test_kernels.py
LOG2E = 1.4426950408889634
TILE = 128            # kSsdTile: Q and N of the tensor-core body, padded


def _slice_width(p: int) -> int:
    """Columns of P a block owns (rt_ssd_scan)."""
    return 16 if p <= 16 else 32


def _split(a: torch.Tensor):
    """f32 -> (hi, lo), each a bf16 value held in f32."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def mma_mirror(xbar, a_log, Bm, Cm, chunk=128, split_att=True):
    """bf16 inputs -> (y bf16, y in f32 before its rounding, h_final
    f32), in the kernel's order of work: every (batch, head, slice) is a
    block, here a batch index, walking the chunks in order.
    ``split_att=False`` rounds att to bf16 once instead of splitting it."""
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    q = chunk_len(s, chunk)
    assert q <= TILE and n <= TILE and xbar.dtype == torch.bfloat16
    nc = -(-s // q)
    qp, npad, ps = TILE, TILE, _slice_width(p)
    slices = -(-p // ps)
    # zero padding: S to whole chunks, P to whole slices, Q and N to the
    # tile
    xs = torch.zeros((b, nc * q, h, slices * ps))
    xs[:, :s, :, :p] = xbar.float()
    xs = xs.view(b, nc, q, h, slices, ps).permute(0, 1, 3, 4, 2, 5)
    bs = torch.zeros((b, nc, qp, npad))
    cs = torch.zeros((b, nc, qp, npad))
    bs.view(b, nc, qp, npad)[:, :, :q, :n] = torch.nn.functional.pad(
        Bm.float(), (0, 0, 0, nc * q - s)).view(b, nc, q, n)
    cs.view(b, nc, qp, npad)[:, :, :q, :n] = torch.nn.functional.pad(
        Cm.float(), (0, 0, 0, nc * q - s)).view(b, nc, q, n)
    als = torch.zeros((b, nc, h, qp))
    als[:, :, :, :q] = torch.nn.functional.pad(
        a_log, (0, 0, 0, nc * q - s)).view(b, nc, q, h).transpose(2, 3)
    tri = torch.tril(torch.ones((qp, qp), dtype=torch.bool))
    state = torch.zeros((b, h, slices, npad, ps))     # f32, in registers
    y32 = torch.zeros((b, nc, h, slices, q, ps))
    for c in range(nc):
        # step 1: the chunk's x slice, B, C and al, zero past Q, N and P
        x = torch.zeros((b, h, slices, qp, ps))
        x[..., :q, :] = xs[:, c]
        bm = bs[:, c, None, None]                      # (b, 1, 1, qp, N)
        cm = cs[:, c, None, None]
        # step 2: l = cumsum(al)
        l = torch.cumsum(als[:, c], -1)[:, :, None]    # decay 1 past q
        lq = l[..., -1:]
        l2 = l * LOG2E
        # step 3, intra: C B^T, exact products of bf16 values, f32 sums
        cb = cm @ bm.transpose(-1, -2)
        # masked before exp: exp2 only where j <= i
        seg = torch.where(tri, l2[..., :, None] - l2[..., None, :],
                          torch.tensor(-float("inf")))
        att = cb * torch.exp2(seg)
        if split_att:
            ahi, alo = _split(att)
            intra = ahi @ x + alo @ x
        else:
            intra = att.bfloat16().float() @ x
        # step 3, inter: C H with H as its hi and lo copies (step 5 of
        # the chunk before), then y = intra + exp(l_i) inter
        hhi, hlo = _split(state)
        inter = cm @ hhi + cm @ hlo
        y32[:, c] = (intra + torch.exp(l)[..., None] * inter)[..., :q, :]
        # step 4: the state update, the weighted x split into hi and lo
        whi, wlo = _split(torch.exp(lq - l)[..., None] * x)
        bt = bm.transpose(-1, -2)
        state = torch.exp(lq)[..., None] * state + bt @ whi + bt @ wlo
    y32 = y32.permute(0, 1, 4, 2, 3, 5).reshape(b, nc * q, h, slices * ps)
    y32 = y32[:, :s, :, :p]
    hout = state.permute(0, 1, 3, 2, 4).reshape(b, h, npad, slices * ps)
    return y32.bfloat16(), y32, hout[:, :, :n, :p].contiguous()


def _inputs(rng, b, s, h, p, n):
    """Random bf16 inputs as ``test_torch_lm_kernels.py`` makes them."""
    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    x = bf(rng.standard_normal((b, s, h, p)) * 0.5)
    al = torch.from_numpy(
        -np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32))
    return (x, al, bf(rng.standard_normal((b, s, n)) * 0.3),
            bf(rng.standard_normal((b, s, n)) * 0.3))


def _scaled_err(got, want) -> float:
    """Largest |got - want| / (TOL + TOL |want|): 1.0 is the edge of
    the bf16 tolerance."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


# test_torch_lm_kernels.py's five SSD shapes, then a padded S at the
# full-width tile (Q = N = 128, P = 64: two slices of 32)
SHAPES = [(2, 96, 3, 16, 32, 32), (1, 128, 2, 64, 128, 128),
          (2, 100, 2, 16, 32, 32), (1, 64, 1, 8, 16, 16),
          (1, 5, 2, 16, 16, 16), (1, 300, 4, 64, 128, 128)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_mirror_matches_plain_and_float64(b, s, h, p, n, chunk):
    rng = np.random.default_rng(1000 + s + p + n)
    x, al, bm, cm = _inputs(rng, b, s, h, p, n)
    y, _, hf = mma_mirror(x, al, bm, cm, chunk)
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, n, p)
    # the plain version the kernel is held to on the card
    y_ref, h_ref = ssd_chunk_scan_ref(x, al, bm, cm, chunk=chunk)
    assert _scaled_err(y, y_ref) <= 1.0
    assert _scaled_err(hf, h_ref) <= 1.0
    # float64: within a fifth of the bf16 tolerance
    y64, h64 = ssd_chunk_scan_ref(*(t.double() for t in (x, al, bm, cm)),
                                  chunk=chunk)
    assert _scaled_err(y, y64) <= 0.2
    assert _scaled_err(hf, h64) <= 0.2


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_split_att_is_closer_to_float64_than_one_rounding(b, s, h, p, n,
                                                          chunk):
    """Before y's own rounding, the split keeps att to about 16 bits and
    one bf16 rounding to 8: the latter lands an order of magnitude
    further from float64 on the same inputs."""
    rng = np.random.default_rng(2000 + s + p + n)
    x, al, bm, cm = _inputs(rng, b, s, h, p, n)
    y64, h64 = ssd_chunk_scan_ref(*(t.double() for t in (x, al, bm, cm)),
                                  chunk=chunk)
    _, y_split, h_split = mma_mirror(x, al, bm, cm, chunk)
    _, y_once, h_once = mma_mirror(x, al, bm, cm, chunk, split_att=False)
    err_split = float((y_split.double() - y64).abs().max())
    err_once = float((y_once.double() - y64).abs().max())
    assert err_once > 10 * err_split, (err_once, err_split)
    # the state update does not read att: both keep the same state
    assert torch.equal(h_split, h_once)


def test_slices_and_padding_do_not_change_the_result():
    """P = 48 is a slice of 32 and a ragged one of 16, Q = 40 and N = 24
    pad to the 128 x 128 tile: the mirror agrees with float64 as closely
    as on whole tiles."""
    rng = np.random.default_rng(7)
    x, al, bm, cm = _inputs(rng, 2, 40, 3, 48, 24)
    y, _, hf = mma_mirror(x, al, bm, cm, 128)
    y64, h64 = ssd_chunk_scan_ref(*(t.double() for t in (x, al, bm, cm)),
                                  chunk=128)
    assert _scaled_err(y, y64) <= 0.2
    assert _scaled_err(hf, h64) <= 0.2
