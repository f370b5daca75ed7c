"""The walk of ``frontier_sweep``'s kernel on the CPU.

The CUDA kernel (``src/repro_torch/core/vecsim/kernels/csrc/
frontier_sweep.cu``) runs only on the card.  A warp takes a unit of R
whole rows (R = 512 // W, 1 to 32; past W = 512 one row, in pieces of
512 cells) and reads the unit's delivered cells, which are contiguous,
as 4-cell words starting on delivered's 16-byte boundaries, with a
scalar head and tail.  It reads the unit's slot flags (``do`` and
``fwd_ok``) once, a lane a slot, as ballot words; lane r turns them into
row r's do and fwd masks of a group of 32 slots.  The candidate cells
(``d == t``; ``d < t`` too in a unit with a flushing slot) are compacted
into a list, which the lanes share out; a listed cell's sending slots
are one bit mask (the fwd mask at ``d == t``; for an app column with
``d < t``, the do slots whose gate is at most ``d``), the flushed count
its popcount, and each send reads its arr cell and lowers it only where
its value is lower.  This file keeps a plain mirror of that walk
and holds it byte for byte against the plain version
``frontier_sweep_ref`` and the JAX package's ``frontier_sweep`` op
(Pallas in interpret mode), and checks that the walk visits every cell
once, reads gate only for flushing slots and is_app only on rows that
have one, and counts the flushed sends of the plain version.

The JAX op is jitted at one shape, (37, 513, 40), and each case is
padded into it: columns with ``delivered = -1`` and ``is_app`` False,
and slots with ``do`` and ``fwd_ok`` False, send nothing and count
nothing, and rows past N are no sending slot's target, so the case's
rows and columns of the padded answer are the case's (one case is also
checked at its own shape).  Targets
outside ``[0, N)`` differ between the references: the port's plain
version drops them, the JAX Pallas op clamps and wraps them into the
plane, and its lax reference wraps the negative ones.  The engines never
send over such a slot (``fwd_ok`` requires ``adj >= 0``), so on that
case the JAX op gets the same inputs with those slots silenced.

Each part of the mirror names the function of ``frontier_sweep.cu`` it
mirrors (``rt_frontier_sweep``, ``frontier_kernel``, ``frontier_piece``
and its steps 1-5, ``frontier_row``, ``cell_mask``, ``bit_field``,
``send_list``): a change to one of those needs the same change here.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.vecsim import kernels as jkx
from repro_torch.core.vecsim.kernels import ref as tref

INF = np.int32(2 ** 30)
PIECE_CELLS = 512      # kFrontierPieceCells of frontier_sweep.cu
WIDTHS = (1, 3, 4, 5, 127, 128, 140, 141, 513)
KS = (1, 3, 17, 32, 33, 40)
ROWS = 37
VARIANTS = ("gate-equal-d", "gate-above-t", "gate-minus-1", "now-app-ping",
            "do-and-fwd", "bad-targets", "all-INF", "arr-lower",
            "all-flushing", "none-flushing")
JAX_SHAPE = (ROWS, max(WIDTHS), max(KS))


def frontier_walk(n, w, k):
    """``rt_frontier_sweep``'s FrontierWalk: rows a unit (R = 512 // W, 1
    to 32; one past W = 512), the units as (first row, rows), and the
    ballot words of a unit's flags (one spare)."""
    rows = min(PIECE_CELLS // w, 32) if w <= PIECE_CELLS else 1
    units = [(r, min(rows, n - r)) for r in range(0, n, rows)]
    return rows, units, -(-rows * k // 32) + 1


def bit_field(bits, pos, nb):
    """``bit_field``: nb bits of the ballot words from bit pos."""
    q, s = pos >> 5, pos & 31
    v = bits[q] >> s
    if s:
        v |= (bits[q + 1] << (32 - s)) & 0xFFFFFFFF
    return v if nb == 32 else v & ((1 << nb) - 1)


def _bits(mask):
    """The set bits of a mask, lowest first (``__ffs``, then clear)."""
    while mask:
        j = (mask & -mask).bit_length() - 1
        mask &= mask - 1
        yield j


def frontier_mirror(arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t,
                    lead=0):
    """The kernel's walk: ``(arr', flushed, stats)`` — the lowered plane,
    the flushed count, and what the walk did: how often each cell was
    visited, which gates were read, on which rows is_app was read, the
    sends and the atomics issued.  ``lead`` is the
    number of cells before delivered's first 16-byte boundary (0 to 3)."""
    n, w = delivered.shape
    k = adj.shape[1]
    out = arr.reshape(-1).copy()
    dflat = delivered.reshape(-1)
    R, units, flag_words = frontier_walk(n, w, k)
    groups = -(-k // 32)
    any_do = False
    visits = np.zeros(n * w, np.int64)
    gate_read = np.zeros((n, k), bool)
    app_read = np.zeros(n, bool)
    stats = dict(sends=0, atomics=0, list_max=0)
    flushed = 0

    def row_of(rel):            # frontier_row
        return 0 if R == 1 else rel // w

    for row0, rows in units:                        # frontier_kernel
        base, end = row0 * w, (row0 + rows) * w
        slots = rows * k
        do_bits = [0] * flag_words
        fwd_bits = [0] * flag_words
        for p0 in range(base, end, PIECE_CELLS):    # frontier_piece
            p1 = min(p0 + PIECE_CELLS, end)
            # 1. whole words from delivered's 16-byte boundary, a scalar
            # head and tail (a lane each)
            k0, k1 = (p0 - lead + 3) // 4, (p1 - lead) // 4
            nwords = max(k1 - k0, 0)
            assert nwords <= PIECE_CELLS // 4      # four words a lane
            wa = lead + 4 * k0 if nwords else p1
            wb = wa + 4 * nwords if nwords else p1
            ends = list(range(p0, wa)) + list(range(wb, p1))
            assert wa - p0 <= (3 if nwords else 6) and p1 - wb <= 3
            # 2. the unit's slot flags, once (first piece), and whether
            # any slot flushes; the kernel stages them as ballot words at
            # the unit's first piece with a candidate (step 4)
            if p0 == base:
                s0 = row0 * k
                for e0 in range(0, slots, 32):
                    ent = range(e0, min(e0 + 32, slots))
                    do_bits[e0 >> 5] = sum(
                        1 << (e - e0) for e in ent if do.flat[s0 + e])
                    fwd_bits[e0 >> 5] = sum(
                        1 << (e - e0) for e in ent if fwd_ok.flat[s0 + e])
                do_bits[(slots + 31) >> 5] = fwd_bits[(slots + 31) >> 5] = 0
                any_do = any(do_bits)
            # 3. the candidates (d == t; d < t too in a unit with a
            # flushing slot), listed in cell order: word slot i of every
            # lane, then the head and tail; a piece without one is done
            lst = []
            for i in range(4):
                for lane in range(32):
                    if i * 32 + lane >= nwords:
                        continue
                    f0 = lead + 4 * (k0 + i * 32 + lane)
                    for f in range(f0, f0 + 4):
                        visits[f] += 1
                        dv = int(dflat[f])
                        if dv == t or (any_do and dv < t):
                            lst.append(f - base)
            assert lst == sorted(lst)                       # cell order
            for f in ends:
                visits[f] += 1
                dv = int(dflat[f])
                if dv == t or (any_do and dv < t):
                    lst.append(f - base)
            assert len(lst) <= PIECE_CELLS
            stats["list_max"] = max(stats["list_max"], len(lst))
            if not lst:
                continue
            # 5. each slot group: row r's masks by lane r, then send_list
            for grp in range(groups):
                nb = min(32, k - 32 * grp)
                row_do = [bit_field(do_bits, r * k + 32 * grp, nb)
                          for r in range(rows)]
                row_fwd = [bit_field(fwd_bits, r * k + 32 * grp, nb)
                           for r in range(rows)]
                for rel in lst:
                    r = row_of(rel)
                    col = rel - r * w
                    dv = int(dflat[base + rel])
                    # cell_mask: the fwd mask at d == t; the flushing
                    # slots with gate <= d for an app column before t
                    if dv == t:
                        mask = row_fwd[r]
                    else:
                        mask = 0
                        if row_do[r]:
                            app_read[row0 + r] = True
                            if is_app[col]:
                                for j in _bits(row_do[r]):
                                    gate_read[row0 + r, 32 * grp + j] = True
                                    if dv >= gate[row0 + r, 32 * grp + j]:
                                        mask |= 1 << j
                        flushed += bin(mask).count("1")
                    # send_list: the arr cell read first, the atomic only
                    # where v is lower
                    slot0 = (row0 + r) * k + 32 * grp
                    for j in _bits(mask):
                        q = int(adj.flat[slot0 + j])
                        v = t + int(delay.flat[slot0 + j])
                        stats["sends"] += 1
                        if 0 <= q < n and v < out[q * w + col]:
                            out[q * w + col] = v          # atomicMin
                            stats["atomics"] += 1
    stats["visits"] = visits
    stats["gate_read"] = gate_read
    stats["app_read"] = app_read
    return out.reshape(n, w), flushed, stats


def _case(rng, n, w, k, variant):
    """numpy inputs of one case: about 40% of the cells delivered before t,
    10% at t, the rest undelivered; gates between -1 and t + 2 on 40% of
    the slots; 30% of the slots flushing, 60% forward-eligible."""
    t = 12
    delivered = np.where(rng.random((n, w)) < 0.4,
                         rng.integers(0, t, (n, w)), -1).astype(np.int32)
    delivered[rng.random((n, w)) < 0.1] = t
    arr = np.where(rng.random((n, w)) < 0.4,
                   rng.integers(t + 1, t + 8, (n, w)), INF).astype(np.int32)
    adj = rng.integers(0, n, (n, k)).astype(np.int32)
    delay = rng.integers(1, 5, (n, k)).astype(np.int32)
    gate = np.where(rng.random((n, k)) < 0.4,
                    rng.integers(-1, t + 3, (n, k)), -1).astype(np.int32)
    do = rng.random((n, k)) < 0.3
    fwd_ok = rng.random((n, k)) < 0.6
    is_app = rng.random(w) < 0.5
    if variant == "gate-equal-d":
        # each flushing slot's gate equal to a delivered value of its row
        pick = rng.integers(0, w, (n, k))
        gate = delivered[np.arange(n)[:, None], pick].astype(np.int32)
        do = rng.random((n, k)) < 0.5
    elif variant == "gate-above-t":
        gate = rng.integers(t + 1, t + 5, (n, k)).astype(np.int32)
        do[:] = True
    elif variant == "gate-minus-1":
        gate[:] = -1
    elif variant == "now-app-ping":
        # half the cells at t, on app and on ping columns alike
        delivered[rng.random((n, w)) < 0.5] = t
        is_app[::2] = True
        is_app[1::2] = False
    elif variant == "do-and-fwd":
        do = rng.random((n, k)) < 0.7
        fwd_ok = do | (rng.random((n, k)) < 0.3)
    elif variant == "bad-targets":
        pick = rng.random((n, k))
        adj[pick < 0.2] = -1
        adj[(pick >= 0.2) & (pick < 0.3)] = n
        adj[(pick >= 0.3) & (pick < 0.4)] = n + 5
        adj[(pick >= 0.4) & (pick < 0.5)] = np.arange(n)[:, None].repeat(
            k, axis=1)[(pick >= 0.4) & (pick < 0.5)]       # the own row
        adj[:, -1] = adj[:, 0]                             # duplicates
        do = rng.random((n, k)) < 0.5
    elif variant == "all-INF":
        arr[:] = INF
    elif variant == "arr-lower":
        # every cell already at or below t + 1 <= t + delay
        arr = rng.integers(0, t + 2, (n, w)).astype(np.int32)
    elif variant == "all-flushing":
        do[:] = True
    elif variant == "none-flushing":
        do[:] = False
    return arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t


def _plain(arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t):
    a, flushed = tref.frontier_sweep_ref(*(torch.from_numpy(np.array(x))
                                           for x in (arr, delivered, adj,
                                                     delay, gate, do, fwd_ok,
                                                     is_app)), t)
    return a.numpy(), int(flushed)


# the JAX op, jitted so that one trace serves every padded case
_jax_sweep = jax.jit(lambda *args: jkx.frontier_sweep(*args, interpret=True))


def _pad(x, shape, fill):
    out = np.full(shape, fill, x.dtype)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def _jax(arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t,
         padded=True):
    """The JAX op's ``(arr', flushed)``, at JAX_SHAPE with inert padding,
    or at the case's own shape."""
    n, w = arr.shape
    k = adj.shape[1]
    if padded:
        nn, ww, kk = JAX_SHAPE
        # padded rows are never a target: every sending slot's target
        # lies in [0, n)
        assert n <= nn and w <= ww and k <= kk
        assert (((adj >= 0) & (adj < n)) | ~(do | fwd_ok)).all()
        arr = _pad(arr, (nn, ww), INF)
        delivered = _pad(delivered, (nn, ww), -1)
        adj, delay, gate = (_pad(x, (nn, kk), 0) for x in (adj, delay, gate))
        do, fwd_ok = _pad(do, (nn, kk), False), _pad(fwd_ok, (nn, kk), False)
        is_app = _pad(is_app, (ww,), False)
        run = _jax_sweep
    else:
        run = lambda *a: jkx.frontier_sweep(*a, interpret=True)  # noqa: E731
    got, flushed = run(arr, delivered, adj, delay, gate, do, fwd_ok, is_app,
                       np.int32(t))
    return np.asarray(got)[:n, :w], int(flushed)


def _check(case, lead=0):
    """The mirror against the plain version; the walk's claims."""
    arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t = case
    n, w = delivered.shape
    k = adj.shape[1]
    got, flushed, st = frontier_mirror(*case, lead=lead)
    want, want_flushed = _plain(*case)
    np.testing.assert_array_equal(got, want)
    assert flushed == want_flushed
    # every cell visited once
    assert (st["visits"] == 1).all()
    # gate read only for flushing slots, and for every flushing slot of a
    # row with an app cell before t
    assert not (st["gate_read"] & ~do).any()
    early = ((delivered < t) & is_app[None, :]).any(axis=1)
    np.testing.assert_array_equal(st["gate_read"], do & early[:, None])
    # is_app read only on rows with a flushing slot
    assert not (st["app_read"] & ~do.any(axis=1)).any()
    # an atomic only where a send lowers its cell
    lowered = int((want != arr).sum())
    assert lowered <= st["atomics"] <= st["sends"]
    return got, flushed, st


@pytest.mark.parametrize("w", WIDTHS)
def test_mirror_matches_plain_and_pallas(w):
    """Every K on random inputs, then every variant (K in rotation), at
    37 rows (5 past W = 512): the mirror byte-equal to the plain version
    and the JAX op."""
    rng = np.random.default_rng(900 + w)
    n = ROWS if w < PIECE_CELLS else 5
    cases = [("random", k) for k in KS]
    cases += [(v, KS[(i + WIDTHS.index(w)) % len(KS)])
              for i, v in enumerate(VARIANTS)]
    for variant, k in cases:
        case = _case(rng, n, w, k, variant)
        got, flushed, st = _check(case)
        if variant == "bad-targets":
            arr, delivered, adj, delay, gate, do, fwd_ok, is_app, t = case
            bad = (adj < 0) | (adj >= n)
            assert st["sends"] > 0 and bad.any()
            case = (arr, delivered, adj, delay, gate, do & ~bad,
                    fwd_ok & ~bad, is_app, t)
            got, flushed, _ = _check(case)
        jgot, jflushed = _jax(*case)
        np.testing.assert_array_equal(got, jgot, f"{variant}, K={k}")
        assert flushed == jflushed, (variant, k)
        if variant == "arr-lower":
            assert st["atomics"] == 0 and st["sends"] > 0
            np.testing.assert_array_equal(got, case[0])
        if variant == "none-flushing":
            assert flushed == 0


@pytest.mark.parametrize("lead", [1, 2, 3])
@pytest.mark.parametrize("w", [4, 128, 140, 141, 513])
def test_mirror_off_a_boundary(w, lead):
    """delivered starting off a 16-byte boundary: words straddle rows
    even at W % 4 == 0, with a head and a tail in each piece."""
    rng = np.random.default_rng(950 + w + lead)
    for variant, k in (("random", 17), ("gate-minus-1", 33)):
        case = _case(rng, 11, w, k, variant)
        got0, flushed0, _ = frontier_mirror(*case)
        got, flushed, _ = _check(case, lead=lead)
        np.testing.assert_array_equal(got, got0)
        assert flushed == flushed0


def test_own_shape_equals_padded():
    """The padding is inert: the JAX op at the case's own shape gives the
    padded answer's first W columns."""
    rng = np.random.default_rng(990)
    case = _case(rng, 20, 140, 17, "do-and-fwd")
    (a, fa), (b, fb) = (_jax(*case, padded=p) for p in (True, False))
    np.testing.assert_array_equal(a, b)
    assert fa == fb


def test_units_and_flag_words():
    """Units that tile the rows: 32 rows at W = 1, 3 at W = 140, 4 at W =
    128, one at W = 512 and past it; the ballot words hold a unit's R x K
    flags with one spare, so bit_field's second word is always inside."""
    for n, w, rows in ((70, 1, 32), (50, 128, 4), (50, 140, 3),
                       (50, 512, 1), (5, 2051, 1)):
        for k in KS:
            r, units, flag_words = frontier_walk(n, w, k)
            assert r == rows and units[0][1] == min(rows, n)
            covered = np.concatenate([np.arange(r0, r0 + m)
                                      for r0, m in units])
            np.testing.assert_array_equal(covered, np.arange(n))
            for row in range(rows):
                for grp in range(-(-k // 32)):
                    assert ((row * k + 32 * grp) >> 5) + 1 < flag_words
