"""The sharded engine's kernels and host pieces in the port, on the CPU.

* ``slot_frontier`` and ``ring_apply`` (``repro_torch.core.vecsim.kernels``,
  whose CPU route is the plain version in ``ref.py``) against the JAX
  package's Pallas ops in interpret mode and its lax references, byte
  for byte: gating on and off, odd and single-column windows, ragged
  column tiles, ``off != 0`` with targets in ``[0, 2·n_loc)`` so that
  half are dropped, duplicate targets and an all-INF plane;
* the frontier bit-plane helpers (``pack_columns``, ``unpack_columns``,
  ``popcount_bytes``) against the JAX package's and ``np.packbits``;
* the port's ``inverse_tables``, ``pad_rows`` and ``topology_digest``
  against ``repro.core.vecsim.shard.mesh``;
* the wrappers check their inputs and launch nothing on the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core.vecsim import kernels as jkx
from repro.core.vecsim.kernels import ref as jref
from repro.core.vecsim.shard import mesh as jmesh
from repro_torch.core.vecsim import kernels as tkx
from repro_torch.core.vecsim.kernels import ref as tref
from repro_torch.core.vecsim.shard import mesh as tmesh

INF = np.int32(2 ** 30)

# (n, w, block_w of the JAX op): odd window, forced ragged tiling,
# single column, a window of 4k columns (the vectorized kernel's case)
SHAPES = [(16, 9, None), (24, 7, 4), (8, 1, None), (12, 11, 3), (10, 8, 4)]


def _slot_inputs(rng, n, w):
    return dict(
        delivered=np.where(rng.random((n, w)) < 0.5,
                           rng.integers(0, 20, (n, w)), -1).astype(np.int32),
        gate_k=np.where(rng.random(n) < 0.5, rng.integers(0, 15, n),
                        -1).astype(np.int32),
        delay_k=rng.integers(1, 4, n).astype(np.int32),
        do_k=rng.random(n) < 0.5,
        fwd_k=rng.random(n) < 0.6,
        is_app=rng.random(w) < 0.7,
        t=int(rng.integers(1, 20)))


def _ring_inputs(rng, n, w, off, all_inf=False):
    vals = np.where(rng.random((n, w)) < 0.5, rng.integers(2, 40, (n, w)),
                    INF).astype(np.int32)
    if all_inf:
        vals[:] = INF
    return dict(
        dest=np.where(rng.random((n, w)) < 0.5, rng.integers(0, 40, (n, w)),
                      INF).astype(np.int32),
        vals=vals,
        # targets in [0, 2n): with off = n half are owned, half dropped;
        # with few distinct values many rows share a target
        tgt=rng.integers(0, 2 * n, n).astype(np.int32),
        off=off)


def _t(iv):
    return {key: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
            else v for key, v in iv.items()}


_SLOT_ARGS = ("delivered", "gate_k", "delay_k", "do_k", "fwd_k", "is_app",
              "t")


@pytest.mark.parametrize("n,w,bw", SHAPES)
@pytest.mark.parametrize("gating", [True, False])
def test_slot_frontier_matches_pallas_and_lax(n, w, bw, gating):
    rng = np.random.default_rng(100 * n + w + gating)
    for _ in range(3):
        iv = _slot_inputs(rng, n, w)
        args = [iv[k] for k in _SLOT_ARGS]
        want_pl = jkx.slot_frontier(*args, gating=gating, block_w=bw,
                                    interpret=True)
        want_lax = jref.slot_frontier_ref(*args, gating=gating)
        a = _t(iv)
        got = tkx.slot_frontier(*[a[k] for k in _SLOT_ARGS], gating)
        plain = tref.slot_frontier_ref(*[a[k] for k in _SLOT_ARGS], gating)
        for want in (want_pl, want_lax):
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            assert int(got[1]) == int(want[1])
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        assert torch.equal(got[0], plain[0]) and int(got[1]) == int(plain[1])
        if not gating:
            assert int(got[1]) == 0


@pytest.mark.parametrize("n,w,bw", SHAPES)
@pytest.mark.parametrize("off_rows", [0, 1])
def test_ring_apply_matches_pallas_and_lax(n, w, bw, off_rows):
    """``off = off_rows * n``: all targets below ``n`` owned (off 0), or
    those in ``[n, 2n)`` (the second shard of a two-rank ring)."""
    rng = np.random.default_rng(7 * n + w + off_rows)
    for all_inf in (False, False, True):
        iv = _ring_inputs(rng, n, w, off_rows * n, all_inf=all_inf)
        args = (iv["dest"], iv["vals"], iv["tgt"], iv["off"])
        want_pl = jkx.ring_apply(*args, block_w=bw, interpret=True)
        want_lax = jref.ring_apply_ref(*args)
        a = _t(iv)
        dest = a["dest"]
        got = tkx.ring_apply(dest, a["vals"], a["tgt"], a["off"])
        assert got is dest           # in place, like the sweeps
        for want in (want_pl, want_lax):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if all_inf:
            np.testing.assert_array_equal(got.numpy(), iv["dest"])


def test_ring_apply_duplicate_and_dropped_targets():
    """Every row aimed at one owned target min-combines there; rows aimed
    outside ``[off, off + n)`` (below, above, and -1 for an empty slot)
    change nothing."""
    n, w, off = 6, 5, 6
    rng = np.random.default_rng(3)
    vals = rng.integers(1, 50, (n, w)).astype(np.int32)
    dest = np.full((n, w), INF, np.int32)
    tgt = np.array([8, 8, 8, 2, 12, -1], np.int32)
    got = tkx.ring_apply(torch.from_numpy(dest.copy()),
                         torch.from_numpy(vals), torch.from_numpy(tgt), off)
    want = dest.copy()
    want[2] = vals[:3].min(axis=0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jref.ring_apply_ref(dest, vals, tgt, off)), want)


@pytest.mark.parametrize("w", [1, 7, 8, 9, 16, 140])
def test_bit_planes_match_reference_and_packbits(w):
    rng = np.random.default_rng(w)
    b = rng.random((13, w)) < 0.4
    got = tkx.pack_columns(torch.from_numpy(b))
    assert got.dtype == torch.uint8 and got.shape == (13, -(-w // 8))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jkx.pack_columns(b)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.packbits(b, axis=1, bitorder="little"))
    back = tkx.unpack_columns(got, w)
    np.testing.assert_array_equal(back.numpy(), b)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jkx.unpack_columns(np.asarray(got), w)))


def test_popcount_bytes_matches_reference():
    x = np.arange(256, dtype=np.uint8)
    got = tkx.popcount_bytes(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jkx.popcount_bytes(x)))
    np.testing.assert_array_equal(
        got.numpy(), np.unpackbits(x[:, None], axis=1).sum(axis=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inverse_tables_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, k = 40, 5
    adj = rng.integers(-1, n, (n, k)).astype(np.int32)
    delay = rng.integers(1, 4, (n, k)).astype(np.int32)
    active = rng.random((n, k)) < 0.8
    sig, tabs = tmesh.inverse_tables(adj, delay, active)
    jsig, jtabs = jmesh.inverse_tables(adj, delay, active)
    assert sig == jsig
    for a, b in zip(tabs, jtabs):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert tmesh.topology_digest(adj, delay, active) == \
        jmesh.topology_digest(adj, delay, active)
    for n_, d in ((64, 4), (61, 4), (5, 2), (7, 1)):
        assert tmesh.pad_rows(n_, d) == jmesh.pad_rows(n_, d)


def test_shard_wrappers_check_inputs_and_launch_nothing_on_cpu():
    rng = np.random.default_rng(11)
    a = _t(_slot_inputs(rng, 6, 5))
    r = _t(_ring_inputs(rng, 6, 5, 0))
    tkx.reset_launches()
    tkx.slot_frontier(*[a[k] for k in _SLOT_ARGS], True)
    tkx.ring_apply(r["dest"], r["vals"], r["tgt"], 0)
    assert tkx.LAUNCHES["slot_frontier"] == tkx.LAUNCHES["ring_apply"] == 0
    with pytest.raises(TypeError, match="int32"):
        tkx.slot_frontier(a["delivered"].long(), *[a[k] for k in
                                                   _SLOT_ARGS[1:]], True)
    with pytest.raises(ValueError, match="shape"):
        tkx.slot_frontier(a["delivered"], a["gate_k"][:4],
                          *[a[k] for k in _SLOT_ARGS[2:]], True)
    with pytest.raises(TypeError, match="bool"):
        tkx.slot_frontier(a["delivered"], a["gate_k"], a["delay_k"],
                          a["do_k"].int(), a["fwd_k"], a["is_app"], 3, True)
    with pytest.raises(ValueError, match="shape"):
        tkx.ring_apply(r["dest"], r["vals"][:, :3], r["tgt"], 0)
    with pytest.raises(ValueError, match="contiguous"):
        tkx.ring_apply(r["dest"].t().contiguous().t(), r["vals"], r["tgt"],
                       0)
    meta = torch.empty((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tkx.ring_apply(meta, meta.clone(),
                       torch.empty(4, dtype=torch.int32, device="meta"), 0)
