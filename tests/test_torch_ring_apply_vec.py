"""The walk of ``ring_apply``'s kernel on the CPU.

The CUDA kernel (``src/repro_torch/core/vecsim/kernels/csrc/
ring_apply.cu``) runs only on the card.  A warp takes a unit of R
visiting rows (R = 512 // W, 1 to 32; past W = 512 a 512-cell piece of
one row), reads their targets first, and skips the unit when
none is owned.  It then reads the unit's vals cells, which are
contiguous, as 4-cell words starting on 16-byte boundaries, skipping a
word whose rows are all foreign; a scalar head and tail cover the cells
before the first and after the last whole word.
A cell that is INF sends nothing; a sent value is compared with its dest
cell and lowers it only where it is lower.  This file keeps a plain
mirror of that walk and holds it byte for byte against the plain version
``ring_apply_ref`` and the JAX package's ``ring_apply`` op (Pallas in
interpret mode), and checks that the walk covers every cell of an owned
row exactly once and, when W is a multiple of 4, reads no cell of a
foreign row.

Each part of the mirror names the device function of ``ring_apply.cu``
it mirrors (``rt_ring_apply``, ``ring_unit``, ``ring_issue``,
``ring_process``, ``ring_cell``): a change to one of those needs the
same change here.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.vecsim import kernels as jkx
from repro_torch.core.vecsim.kernels import ref as tref

INF = np.int32(2 ** 30)
UNIT_CELLS = 512       # kRingUnitCells of ring_apply.cu: 128 words
WIDTHS = (1, 3, 4, 5, 128, 140, 141)
VARIANTS = ("random", "duplicate", "dropped", "all-foreign", "all-INF",
            "dest-lower")


def ring_mirror(dest, vals, tgt, off, lead=0):
    """The kernel's walk: ``(dest', visits, read)`` — the updated plane,
    how often each vals cell was visited, and which were read.
    ``lead`` is the number of cells before vals' first 16-byte
    boundary (0 to 3)."""
    n, w = dest.shape
    out = dest.copy()
    flat = vals.reshape(-1)
    visits = np.zeros(n * w, np.int64)
    read = np.zeros(n * w, bool)


    def cell(f, base, tl):
        # ring_cell: INF sends nothing, a sent value lowers dest only
        # where it is lower
        visits[f] += 1
        r = (f - base) // w
        if tl[r] < 0:
            return
        read[f] = True
        v = flat[f]
        col = f - base - r * w
        if v != INF and v < out[tl[r], col]:
            out[tl[r], col] = v

    for row0, rr, c0, c1 in ring_units(n, w):
        base = row0 * w
        tl = tgt[row0:row0 + rr].astype(np.int64) - off
        tl = np.where((tl >= 0) & (tl < n), tl, -1)
        # ring_issue: the warp skips a unit whose rows are all foreign
        if (tl < 0).all():          # every row foreign: nothing is read
            visits[c0:c1] += 1
            continue
        # ring_unit: the unit's whole 4-cell words from a 16-byte boundary
        k0, k1 = (c0 - lead + 3) // 4, (c1 - lead) // 4
        nwords = max(k1 - k0, 0)
        assert nwords <= UNIT_CELLS // 4     # one batch of 4 words a lane
        for k in range(k0, k0 + nwords):
            # ring_issue reads a word's vals only when one of its cells
            # lies in an owned row; ring_process lowers dest cell by cell
            f = lead + 4 * k
            owned = any(tl[(f + e - base) // w] >= 0 for e in range(4))
            for e in range(4):
                if owned:
                    cell(f + e, base, tl)
                else:
                    visits[f + e] += 1
        # ring_process: the head and tail cells, a lane each
        wa = lead + 4 * k0 if nwords else c1
        wb = lead + 4 * k1 if nwords else c1
        assert wa - c0 <= (3 if nwords else 6) and c1 - wb <= 3
        for f in list(range(c0, wa)) + list(range(wb, c1)):
            cell(f, base, tl)
    return out, visits, read


def ring_units(n, w):
    """The kernel's units as (first row, rows, first cell, past the last
    cell): R = 512 // W rows (1 to 32), or 512-cell pieces of a row past
    W = 512 (``rt_ring_apply``'s RingWalk and ``ring_unit``)."""
    if w <= UNIT_CELLS:
        rows = min(UNIT_CELLS // w, 32)
        return [(r, min(rows, n - r), r * w, min(r + rows, n) * w)
                for r in range(0, n, rows)]
    return [(r, 1, r * w + c, min(r * w + c + UNIT_CELLS, (r + 1) * w))
            for r in range(n) for c in range(0, w, UNIT_CELLS)]


def _case(rng, n, w, off, variant):
    vals = np.where(rng.random((n, w)) < 0.5, rng.integers(2, 40, (n, w)),
                    INF).astype(np.int32)
    dest = np.where(rng.random((n, w)) < 0.5, rng.integers(0, 40, (n, w)),
                    INF).astype(np.int32)
    tgt = rng.integers(0, 2 * n, n)
    if variant == "duplicate":
        tgt = off + rng.integers(0, 3, n)
    elif variant == "dropped":
        tgt = rng.integers(-n, 3 * n, n)
        tgt[::5] = -1
    elif variant == "all-foreign":
        tgt = off + n + rng.integers(0, n, n)
    elif variant == "all-INF":
        vals[:] = INF
    elif variant == "dest-lower":
        dest[:] = 1
    return dest, vals, tgt.astype(np.int32)


# the JAX op, jitted so that one trace serves every case of a shape
_jax_ring = jax.jit(lambda dest, vals, tgt, off: jkx.ring_apply(
    dest, vals, tgt, off, interpret=True))


def _plain(dest, vals, tgt, off):
    return tref.ring_apply_ref(torch.from_numpy(dest), torch.from_numpy(vals),
                               torch.from_numpy(tgt), off).numpy()


@pytest.mark.parametrize("w", WIDTHS)
def test_mirror_matches_plain_and_pallas(w):
    n = 21
    rng = np.random.default_rng(400 + w)
    for off in (0, n):
        for variant in VARIANTS:
            dest, vals, tgt = _case(rng, n, w, off, variant)
            got, visits, read = ring_mirror(dest, vals, tgt, off)
            want = _plain(dest, vals, tgt, off)
            np.testing.assert_array_equal(got, want, f"{variant} off {off}")
            np.testing.assert_array_equal(
                np.asarray(_jax_ring(dest, vals, tgt, np.int32(off))), want,
                f"{variant} off {off}")
            assert (visits == 1).all()
            if variant in ("all-INF", "dest-lower", "all-foreign"):
                np.testing.assert_array_equal(got, dest)
            foreign = ~((tgt.astype(np.int64) - off >= 0)
                        & (tgt.astype(np.int64) - off < n))
            if variant == "all-foreign":
                assert not read.any()
            if w % 4 == 0:
                # whole words in a row: a foreign row is never read
                assert not read.reshape(n, w)[foreign].any()


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("w", [4, 128, 141, 2051])
def test_mirror_off_a_boundary_and_wide(w, lead):
    """vals starting off a 16-byte boundary: words straddle rows even at
    W % 4 == 0, with a head and a tail in each unit; and a W past 512,
    cut into 512-cell pieces of a row."""
    n = 19
    rng = np.random.default_rng(500 + w + lead)
    for off in (0, n):
        dest, vals, tgt = _case(rng, n, w, off, "random")
        got, visits, _ = ring_mirror(dest, vals, tgt, off, lead=lead)
        np.testing.assert_array_equal(got, _plain(dest, vals, tgt, off))
        assert (visits == 1).all()


def test_units():
    """Units of at most 512 cells that tile the plane: 4 rows at W = 128,
    3 at W = 140, 32 at W = 1, one row at W = 512, five pieces of a row
    at W = 2,051."""
    for n, w, rows in ((50, 1, 32), (50, 128, 4), (50, 140, 3),
                       (50, 512, 1), (5, 2051, 1)):
        units = ring_units(n, w)
        assert all(r <= rows and c1 - c0 <= UNIT_CELLS
                   for _, r, c0, c1 in units)
        assert units[0][1] == min(rows, n)
        cells = np.concatenate([np.arange(c0, c1) for *_, c0, c1 in units])
        np.testing.assert_array_equal(cells, np.arange(n * w))
    assert len(ring_units(5, 2051)) == 25
