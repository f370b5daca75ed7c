"""The logic of ``fused_sweep``'s pull on the CPU.

The CUDA kernel (``csrc/fused_sweep.cu``) forwards by a pull in two
passes: a plane pass that delivers, counts and writes a bitmask of the
cells delivered at ``t``, then a forward in which every ``arr`` cell
takes the min over its row's in-edges, read from an inverse adjacency
table.  The kernel runs only on the card; here the table's builder
(``ops.build_inverse_table``), its cache (``ops.inverse_table``) and a
plain-tensor mirror of the two passes, kept in this file, are held byte
for byte against ``adj`` and against ``ref.fused_sweep_ref``, the plain
version the kernel is held to on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.vecsim import sim
from repro_torch.core.vecsim.kernels import ops
from repro_torch.core.vecsim.kernels import ref as tref
from repro_torch.core.vecsim.scenario import link_add_scenario

INF = 2 ** 30
PLANE_COLS = 128  # kPlaneCols of fused_sweep.cu: 4 mask words


def _adj(rng, n, k):
    """Targets in [-2, N + 3): -1 and out-of-range slots, duplicates (row
    1 sends every slot to one target), and more than 32 in-edges on row
    0 when N allows."""
    adj = rng.integers(-2, n + 3, (n, k))
    adj[rng.random((n, k)) < 0.2] = -1
    adj[:, 0] = np.where(rng.random(n) < 0.5, 0, adj[:, 0])
    adj[1] = adj[1, 0]
    return torch.from_numpy(adj.astype(np.int32))


@pytest.mark.parametrize("k", [1, 8, 17])
def test_inverse_table_matches_adj(k):
    rng = np.random.default_rng(100 + k)
    n = 90
    adj = _adj(rng, n, k)
    ptr, slot = ops.build_inverse_table(adj)
    assert ptr.dtype == slot.dtype == torch.int32
    assert ptr.shape == (n + 1,) and slot.shape == (n * k,)
    flat = adj.reshape(-1).numpy()
    valid = (flat >= 0) & (flat < n)
    assert int(ptr[0]) == 0 and int(ptr[n]) == int(valid.sum())
    for q in range(n):
        want = np.flatnonzero(flat == q)
        got = slot[int(ptr[q]):int(ptr[q + 1])].numpy()
        np.testing.assert_array_equal(got, want, f"in-edges of row {q}")
    # the dropped slots follow, each once
    np.testing.assert_array_equal(np.sort(slot[int(ptr[n]):].numpy()),
                                  np.flatnonzero(~valid))
    assert int(ptr[1] - ptr[0]) > 32     # row 0: more than one batch
    if k > 1:
        q1 = int(adj[1, 0])
        if 0 <= q1 < n:   # row 1's duplicate edges are all kept
            got = slot[int(ptr[q1]):int(ptr[q1 + 1])].numpy()
            assert set(range(k, 2 * k)) <= set(got.tolist())


def _pack(now: torch.Tensor) -> torch.Tensor:
    """Pass 1's mask: (N, 4 * ceil(W / 128)) words of 32 cells, bit j of
    word i the cell of column 32 i + j; 0 past W."""
    n, w = now.shape
    words = 4 * -(-w // PLANE_COLS)
    padded = torch.zeros((n, words * 32), dtype=torch.int64)
    padded[:, :w] = now.to(torch.int64)
    return (padded.view(n, words, 32) << torch.arange(32)).sum(dim=2)


def _pull_mirror(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t):
    """The kernel's two passes in plain tensor operations."""
    n, w = arr.shape
    k = adj.shape[1]
    # pass 1: deliver, count, mask
    fresh = (delivered < 0) & ~crashed[:, None] & (arr == t)
    delivered = delivered.masked_fill(fresh, t)
    now = delivered == t
    napp = (now & is_app).sum(dim=1, dtype=torch.int32)
    nping = (now & ~is_app).sum(dim=1, dtype=torch.int32)
    bits = _pack(now)
    assert bits.shape[1] % 4 == 0
    # pass 2: every cell (q, m) takes the min over q's in-edges
    ptr, slot = ops.build_inverse_table(adj)
    arr = arr.clone()
    cols = torch.arange(w)
    for q in range(n):
        edges = slot[int(ptr[q]):int(ptr[q + 1])].long()
        if not len(edges):
            continue
        p, kk = edges // k, edges % k
        ok = fwd_ok[p, kk]
        sent = ((bits[p][:, cols // 32] >> (cols % 32)) & 1).bool()
        sent &= ok[:, None]
        value = (t + delay[p, kk]).to(torch.int32)[:, None].expand(-1, w)
        cand = torch.where(sent, value, INF).amin(dim=0)
        arr[q] = torch.where(cand < arr[q], cand, arr[q])
    return arr, delivered, napp, nping


def _case(rng, n, w, k, *, crash=0.2, fwd=0.6, retired=False):
    t = int(rng.integers(1, 20))
    arr = np.where(rng.random((n, w)) < 0.4, rng.integers(0, 25, (n, w)),
                   INF)
    delivered = np.where(rng.random((n, w)) < 0.4,
                         rng.integers(0, 20, (n, w)), -1)
    delivered[rng.random((n, w)) < 0.3] = t
    if retired:
        arr[:] = INF
        delivered[:] = -1
    return (torch.from_numpy(arr.astype(np.int32)),
            torch.from_numpy(delivered.astype(np.int32)),
            torch.from_numpy(rng.random(n) < crash),
            _adj(rng, n, k),
            torch.from_numpy(rng.integers(1, 6, (n, k)).astype(np.int32)),
            torch.from_numpy(rng.random((n, k)) < fwd),
            torch.from_numpy(rng.random(w) < 0.7), t)


CASES = {
    "odd_w33_k8": dict(n=70, w=33, k=8),
    "w31_k17": dict(n=40, w=31, k=17),
    "w257_k1": dict(n=50, w=257, k=1),
    "w1_k8": dict(n=60, w=1, k=8),
    "w300_k17_mixed": dict(n=36, w=300, k=17),
    "many_crashed": dict(n=64, w=45, k=8, crash=0.7),
    "fwd_ok_off": dict(n=48, w=50, k=8, fwd=0.0),
    "all_retired": dict(n=30, w=70, k=8, retired=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pull_mirror_equals_plain_version(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    args = _case(rng, **CASES[name])
    want = tref.fused_sweep_ref(*args)
    got = _pull_mirror(*args)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    # the wrapper (the plain version on the CPU) agrees, in place
    arr, delivered = args[0].clone(), args[1].clone()
    out = ops.fused_sweep(arr, delivered, *args[2:])
    assert out[0] is arr and out[1] is delivered
    for g, w_ in zip(out, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


def test_mask_words_past_the_window_are_zero():
    now = torch.ones((3, 257), dtype=torch.bool)
    bits = _pack(now)
    assert bits.shape == (3, 12)
    assert int(bits[0, 8]) == 1 and int(bits[0, 9:].abs().sum()) == 0
    assert ops.forward_mask(3, 257, "cpu").shape == (3, 12)
    assert ops.forward_mask(3, 256, "cpu").shape == (3, 8)


def test_inverse_table_cache_follows_adj():
    rng = np.random.default_rng(7)
    adj = _adj(rng, 40, 8)
    first = ops.inverse_table(adj)
    assert ops.inverse_table(adj) is first
    adj[3, 2] = 11          # an in-place edit bumps the version counter
    second = ops.inverse_table(adj)
    assert second is not first
    for a, b in zip(second, ops.build_inverse_table(adj)):
        assert torch.equal(a, b)
    same = adj.clone()      # equal content, another tensor: built anew
    assert ops.inverse_table(same) is not second
    assert ops.inverse_table(same) is ops.inverse_table(same)


def test_link_addition_rebuilds_the_table():
    """The engine edits adj in place on a link addition (phase 2 of
    ``sim.apply_events``): the version counter moves and the cached table
    is rebuilt to include the new edge."""
    scn = link_add_scenario(3, 24, k=4, n_adds=6)
    ds = sim.DeviceSchedule(sim.full_schedule(scn), torch.device("cpu"))
    st = sim.state_to_device(sim.init_topo_state(scn, scn.m_total),
                             torch.device("cpu"))
    adj = st["adj"]
    t = int(scn.add_round[0])
    for r in range(t):
        sim.apply_events(st, ds, r, pc=True, always_gate=False)
    before = ops.inverse_table(adj)
    version = adj._version
    sim.apply_events(st, ds, t, pc=True, always_gate=False)
    assert adj._version > version
    after = ops.inverse_table(adj)
    assert after is not before
    for a, b in zip(after, ops.build_inverse_table(adj)):
        assert torch.equal(a, b)
    p, kk, q = (int(x[scn.add_round == t][0])
                for x in (scn.add_p, scn.add_k, scn.add_q))
    ptr, slot = after
    assert p * 4 + kk in slot[int(ptr[q]):int(ptr[q + 1])].tolist()
