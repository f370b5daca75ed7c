"""The walk of ``deliver_sweep``'s kernel on the CPU.

The CUDA kernel (``src/repro_torch/core/vecsim/kernels/csrc/
deliver_sweep.cu``) runs only on the card.  A warp takes a unit of R
whole rows (R = 512 // W, 1 to 32; past W = 512 one row, in pieces of
512 cells), reads each row's crashed flag once, and reads the unit's
delivered cells, which are contiguous, as 4-cell words starting on
16-byte boundaries; a scalar head and tail cover the cells before the
first and after the last whole word of a piece.  It reads the arr word
only where a cell of it is undelivered on a live row, writes a
delivered word only where a cell changes, and folds each row's app and
ping counts by warp reductions into one store a row.  This file keeps a
plain mirror of that walk and holds it byte for byte against the plain
version ``deliver_sweep_ref`` and the JAX package's ``deliver_sweep``
op (Pallas in interpret mode), and checks that the walk visits every
cell once, reads arr only where the output depends on it, and counts
each row from its own cells only.

Each part of the mirror names the function of ``deliver_sweep.cu`` it
mirrors (``rt_deliver_sweep``, ``deliver_kernel``, ``deliver_piece`` and
its steps 1-4, ``unit_row``): a change to one of those needs the same
change here.
"""

import numpy as np
import pytest
import torch

from repro.core.vecsim import kernels as jkx
from repro_torch.core.vecsim.kernels import ref as tref

INF = np.int32(2 ** 30)
PIECE_CELLS = 512      # kDeliverPieceCells of deliver_sweep.cu
PING_UNIT = 1 << 16    # kPingUnit: a ping delivery in a packed count
WIDTHS = (1, 3, 4, 5, 127, 128, 140, 141, 513)
VARIANTS = ("random", "crashed", "all-delivered", "all-undelivered",
            "arr-t-on-delivered")


def deliver_units(n, w):
    """``rt_deliver_sweep``'s DeliverWalk: the units as (first row,
    rows): R = 512 // W rows (1 to 32), one row past W = 512."""
    rows = min(PIECE_CELLS // w, 32) if w <= PIECE_CELLS else 1
    return [(r, min(rows, n - r)) for r in range(0, n, rows)]


def deliver_mirror(arr, delivered, crashed, is_app, t, lead=0):
    """The kernel's walk: ``(delivered', napp, nping, visits,
    arr_read, row_of_count)`` — the updated plane, the counts, how often
    each cell was visited, which arr cells were read, and for every
    counted cell the row whose count it went to.  ``lead`` is the
    number of cells before delivered's first 16-byte boundary (0 to
    3)."""
    n, w = delivered.shape
    out = delivered.reshape(-1).copy()
    flat_arr = arr.reshape(-1)
    napp = np.full(n, -1, np.int64)       # the kernel stores every row
    nping = np.full(n, -1, np.int64)
    visits = np.zeros(n * w, np.int64)
    arr_read = np.zeros(n * w, bool)
    count_row = np.full(n * w, -1, np.int64)

    for row0, rows in deliver_units(n, w):
        # deliver_kernel: crashed read once a row (lane r, one ballot)
        dead = crashed[row0:row0 + rows]
        base, end = row0 * w, (row0 + rows) * w
        app = np.zeros(rows, np.int64)
        ping = np.zeros(rows, np.int64)

        def unit_row(rel):
            return 0 if rows == 1 else rel // w

        for p0 in range(base, end, PIECE_CELLS):
            p1 = min(p0 + PIECE_CELLS, end)
            # deliver_piece: whole words from delivered's 16-byte
            # boundary, a scalar head and tail
            k0, k1 = (p0 - lead + 3) // 4, (p1 - lead) // 4
            nwords = max(k1 - k0, 0)
            assert nwords <= PIECE_CELLS // 4      # four words a lane
            wa = lead + 4 * k0 if nwords else p1
            wb = wa + 4 * nwords if nwords else p1
            assert wa - p0 <= (3 if nwords else 6) and p1 - wb <= 3
            cells = ([list(range(lead + 4 * k, lead + 4 * k + 4))
                      for k in range(k0, k0 + nwords)]
                     + [[f] for f in range(p0, wa)]
                     + [[f] for f in range(wb, p1)])
            packed = np.zeros(rows, np.int64)
            for word in cells:
                # steps 1-2: the delivered word, then the arr word only
                # where a cell is undelivered on a live row
                need = [out[f] < 0 and not dead[unit_row(f - base)]
                        for f in word]
                if any(need):          # one 16-byte load (arr aligned as
                    arr_read[word] = True  # delivered) or a scalar
                # step 3: deliver, write only changed cells, count
                for f, nd in zip(word, need):
                    visits[f] += 1
                    if nd and flat_arr[f] == t:
                        out[f] = t
                    if out[f] == t:
                        r = unit_row(f - base)
                        col = f - base - r * w
                        packed[r] += 1 if is_app[col] else PING_UNIT
                        count_row[f] = row0 + r
            # step 4: one warp reduction a row of the piece, into lane r
            app += packed & (PING_UNIT - 1)
            ping += packed >> 16
        # one plain store a row
        napp[row0:row0 + rows] = app
        nping[row0:row0 + rows] = ping
    return (out.reshape(n, w), napp.astype(np.int32),
            nping.astype(np.int32), visits, arr_read, count_row)


def _case(rng, n, w, variant):
    t = int(rng.integers(1, 20))
    arr = np.where(rng.random((n, w)) < 0.5,
                   rng.integers(0, 25, (n, w)), INF).astype(np.int32)
    arr[rng.random((n, w)) < 0.3] = t          # plenty of arrivals at t
    delivered = np.where(rng.random((n, w)) < 0.4,
                         rng.integers(0, 20, (n, w)), -1).astype(np.int32)
    delivered[rng.random((n, w)) < 0.1] = t
    crashed = rng.random(n) < 0.1
    is_app = rng.random(w) < 0.7
    if variant == "crashed":
        crashed = rng.random(n) < 0.5
    elif variant == "all-delivered":
        delivered = rng.integers(0, 20, (n, w)).astype(np.int32)
    elif variant == "all-undelivered":
        delivered[:] = -1
    elif variant == "arr-t-on-delivered":
        delivered = np.where(rng.random((n, w)) < 0.5,
                             rng.integers(0, 20, (n, w)), -1).astype(np.int32)
        arr[delivered >= 0] = t
    return arr, delivered, crashed, is_app, t


def _plain(arr, delivered, crashed, is_app, t):
    out = tref.deliver_sweep_ref(*(torch.from_numpy(x) for x in (
        arr, delivered, crashed, is_app)), t)
    return tuple(x.numpy() for x in out)


def _check(arr, delivered, crashed, is_app, t, lead=0):
    n, w = delivered.shape
    d2, napp, nping, visits, arr_read, count_row = deliver_mirror(
        arr, delivered, crashed, is_app, t, lead)
    want = _plain(arr, delivered, crashed, is_app, t)
    for got, exp in zip((d2, napp, nping), want):
        np.testing.assert_array_equal(got, exp)
    # every cell visited once; arr read wherever the output depends on
    # it (undelivered on a live row), elsewhere only in the words of such
    # cells, which lie in one row when W % 4 == 0 and lead == 0
    assert (visits == 1).all()
    need = (delivered < 0) & ~crashed[:, None]
    read = arr_read.reshape(n, w)
    assert read[need].all()
    assert read.sum() <= 4 * need.sum()
    if w % 4 == 0 and lead == 0:
        assert not read[crashed].any()
        assert not read[~need.any(axis=1)].any()
    # each row's counts come from its own cells: the cells counted are
    # those delivered at t afterwards, each to its own row
    rows = np.repeat(np.arange(n), w)
    counted = count_row >= 0
    np.testing.assert_array_equal(counted, (d2 == t).reshape(-1))
    np.testing.assert_array_equal(count_row[counted], rows[counted])
    return want


@pytest.mark.parametrize("w", WIDTHS)
def test_mirror_matches_plain_and_pallas(w):
    n = 37 if w < 500 else 5
    rng = np.random.default_rng(700 + w)
    for variant in VARIANTS:
        arr, delivered, crashed, is_app, t = _case(rng, n, w, variant)
        want = _check(arr, delivered, crashed, is_app, t)
        got = jkx.deliver_sweep(arr, delivered, crashed, is_app, t,
                                interpret=True)
        for g, e in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), e, variant)
        if variant == "all-delivered":
            np.testing.assert_array_equal(want[0], delivered)


@pytest.mark.parametrize("lead", [1, 2, 3])
@pytest.mark.parametrize("w", [4, 128, 140, 141, 513])
def test_mirror_off_a_boundary(w, lead):
    """delivered starting off a 16-byte boundary: words straddle rows
    even at W % 4 == 0, with a head and a tail in each piece."""
    n = 11
    rng = np.random.default_rng(800 + w + lead)
    for variant in ("random", "crashed"):
        _check(*_case(rng, n, w, variant), lead=lead)


def test_units():
    """Units that tile the rows: 32 rows at W = 1, 3 at W = 140, 4 at W =
    128, one at W = 512 and past it; past W = 512 a row is walked in
    pieces of at most 512 cells."""
    for n, w, rows in ((70, 1, 32), (50, 128, 4), (50, 140, 3),
                       (50, 512, 1), (5, 2051, 1)):
        units = deliver_units(n, w)
        assert units[0][1] == min(rows, n)
        assert all(r <= rows for _, r in units)
        assert rows * w <= PIECE_CELLS or rows == 1
        covered = np.concatenate([np.arange(r0, r0 + r) for r0, r in units])
        np.testing.assert_array_equal(covered, np.arange(n))
