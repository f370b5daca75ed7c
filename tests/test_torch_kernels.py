"""The port's sweep-kernel wrappers (``repro_torch.core.vecsim.kernels``)
on the CPU, where each runs its plain PyTorch version.

Each op is held byte for byte against the JAX package's Pallas op run in
interpret mode and against its lax reference (``kernels/ref.py``), on
the same numpy-seeded inputs as ``test_vecsim_kernels.py``: odd windows,
ragged column tiles, the single-column window, and an all-retired
window.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions there); here
the tests check that a CUDA request without a card raises instead of
falling back to the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core.vecsim import kernels as jkx
from repro.core.vecsim.kernels import ref as jref
from repro_torch.backend import DeviceUnavailableError, resolve_device
from repro_torch.core.vecsim import kernels as tkx
from repro_torch.core.vecsim.kernels import _build
from repro_torch.core.vecsim.kernels import ref as tref

INF = np.int32(2 ** 30)

# (n, w, k, block_w of the JAX op): odd window, forced ragged tiling,
# single column — the shapes of test_vecsim_kernels.py
SHAPES = [(16, 9, 3, None), (24, 7, 4, 4), (8, 1, 2, None), (12, 11, 3, 3)]


def _inputs(rng, n, w, k):
    return dict(
        t=int(rng.integers(1, 20)),
        arr=np.where(rng.random((n, w)) < 0.4,
                     rng.integers(0, 25, (n, w)), INF).astype(np.int32),
        delivered=np.where(rng.random((n, w)) < 0.4,
                           rng.integers(0, 20, (n, w)), -1).astype(np.int32),
        crashed=rng.random(n) < 0.2,
        is_app=rng.random(w) < 0.7,
        adj=rng.integers(0, n, (n, k)).astype(np.int32),
        delay=rng.integers(1, 4, (n, k)).astype(np.int32),
        gate=np.where(rng.random((n, k)) < 0.3,
                      rng.integers(0, 15, (n, k)), -1).astype(np.int32),
        do=rng.random((n, k)) < 0.3,
        fwd=rng.random((n, k)) < 0.6,
        min_gate=np.where(rng.random(n) < 0.3,
                          rng.integers(0, 15, n), INF).astype(np.int32),
    )


def _t(iv):
    """torch CPU copies of the numpy inputs (fresh, since the port's
    sweeps update arr/delivered in place)."""
    return {key: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
            else v for key, v in iv.items()}


def _eq(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _port_ops(iv, rounds):
    """All four port ops on fresh CPU tensors, as numpy tuples."""
    a = _t(iv)
    deliver = tkx.deliver_sweep(a["arr"], a["delivered"], a["crashed"],
                                a["is_app"], a["t"])
    a = _t(iv)
    fused = tkx.fused_sweep(a["arr"], a["delivered"], a["crashed"], a["adj"],
                            a["delay"], a["fwd"], a["is_app"], a["t"])
    a = _t(iv)
    frontier = tkx.frontier_sweep(a["arr"], a["delivered"], a["adj"],
                                  a["delay"], a["gate"], a["do"], a["fwd"],
                                  a["is_app"], a["t"])
    a = _t(iv)
    retire = tkx.retire_reduce(a["arr"], a["delivered"], a["crashed"],
                               a["min_gate"], rounds)
    return {name: tuple(x.numpy() for x in out) for name, out in
            (("deliver", deliver), ("fused", fused),
             ("frontier", frontier), ("retire", retire))}


@pytest.mark.parametrize("n,w,k,bw", SHAPES)
def test_ops_match_pallas_interpret(n, w, k, bw):
    """Each port op == the JAX Pallas op (interpret mode), bit for bit,
    across the JAX op's column tilings."""
    rng = np.random.default_rng(n * 1000 + w)
    iv = _inputs(rng, n, w, k)
    t, rounds = iv["t"], 22
    got = _port_ops(iv, rounds)
    kw = dict(block_w=bw, interpret=True)
    _eq(got["deliver"], jkx.deliver_sweep(
        iv["arr"], iv["delivered"], iv["crashed"], iv["is_app"], t, **kw))
    _eq(got["fused"], jkx.fused_sweep(
        iv["arr"], iv["delivered"], iv["crashed"], iv["adj"], iv["delay"],
        iv["fwd"], iv["is_app"], t, **kw))
    _eq(got["frontier"], jkx.frontier_sweep(
        iv["arr"], iv["delivered"], iv["adj"], iv["delay"], iv["gate"],
        iv["do"], iv["fwd"], iv["is_app"], t, **kw))
    _eq(got["retire"], jkx.retire_reduce(
        iv["arr"], iv["delivered"], iv["crashed"], iv["min_gate"],
        np.int32(rounds), **kw))


@pytest.mark.parametrize("n,w,k,bw", SHAPES)
def test_ops_match_lax_refs(n, w, k, bw):
    """Each port op == the JAX package's lax reference (kernels/ref.py),
    and the record-side reductions == plain numpy."""
    rng = np.random.default_rng(n * 7 + w)
    iv = _inputs(rng, n, w, k)
    t, rounds = iv["t"], 22
    got = _port_ops(iv, rounds)
    _eq(got["deliver"], jref.deliver_sweep_ref(
        iv["arr"], iv["delivered"], iv["crashed"], iv["is_app"], t))
    _eq(got["fused"], jref.fused_sweep_ref(
        iv["arr"], iv["delivered"], iv["crashed"], iv["adj"], iv["delay"],
        iv["fwd"], iv["is_app"], t))
    _eq(got["frontier"], jref.frontier_sweep_ref(
        iv["arr"], iv["delivered"], iv["adj"], iv["delay"], iv["gate"],
        iv["do"], iv["fwd"], iv["is_app"], t))
    _eq(got["retire"], jref.retire_reduce_ref(
        iv["arr"], iv["delivered"], iv["crashed"], iv["min_gate"], rounds))
    _, _, _, arrcnt, sumdel = got["retire"]
    np.testing.assert_array_equal(arrcnt, (iv["arr"] < rounds).sum(axis=0))
    np.testing.assert_array_equal(
        sumdel, np.where(iv["delivered"] >= 0, iv["delivered"], 0)
        .sum(axis=0))
    assert sumdel.dtype == np.int64


def test_ops_on_all_retired_window():
    """An all-retired window (arr=INF, delivered=-1) sweeps to a no-op
    with zero counts, like the JAX kernels."""
    n, w, k = 10, 6, 3
    iv = dict(t=5, arr=np.full((n, w), INF, np.int32),
              delivered=np.full((n, w), -1, np.int32),
              crashed=np.zeros(n, bool), is_app=np.ones(w, bool),
              adj=np.zeros((n, k), np.int32), delay=np.ones((n, k), np.int32),
              gate=np.full((n, k), -1, np.int32), do=np.zeros((n, k), bool),
              fwd=np.ones((n, k), bool),
              min_gate=np.full(n, INF, np.int32))
    got = _port_ops(iv, 9)
    a2, d2, napp, nping = got["fused"]
    np.testing.assert_array_equal(a2, iv["arr"])
    np.testing.assert_array_equal(d2, iv["delivered"])
    assert napp.sum() == 0 and nping.sum() == 0
    assert got["frontier"][1] == 0
    assert all(x.sum() == 0 for x in got["retire"])
    _eq(got["fused"], jkx.fused_sweep(
        iv["arr"], iv["delivered"], iv["crashed"], iv["adj"], iv["delay"],
        iv["fwd"], iv["is_app"], iv["t"], interpret=True))


def test_sweeps_update_in_place_and_plain_versions_are_pure():
    """The wrappers update arr/delivered in place and return the same
    tensors; the plain versions never write their inputs."""
    iv = _inputs(np.random.default_rng(3), 12, 11, 3)
    a = _t(iv)
    arr, delivered = a["arr"], a["delivered"]
    out = tkx.fused_sweep(arr, delivered, a["crashed"], a["adj"], a["delay"],
                          a["fwd"], a["is_app"], a["t"])
    assert out[0] is arr and out[1] is delivered
    b = _t(iv)
    tref.fused_sweep_ref(b["arr"], b["delivered"], b["crashed"], b["adj"],
                         b["delay"], b["fwd"], b["is_app"], b["t"])
    np.testing.assert_array_equal(b["arr"].numpy(), iv["arr"])
    np.testing.assert_array_equal(b["delivered"].numpy(), iv["delivered"])


def test_out_of_range_targets_are_dropped():
    """A scatter target outside [0, N) is dropped, as mode='drop' does."""
    n, w, k = 4, 3, 2
    arr = torch.full((n, w), int(INF), dtype=torch.int32)
    arr[0, :] = 5                       # row 0 delivers column 0..2 at t=5
    delivered = torch.full((n, w), -1, dtype=torch.int32)
    adj = torch.tensor([[n, -1], [0, 1], [0, 1], [0, 1]], dtype=torch.int32)
    out = tkx.fused_sweep(arr, delivered, torch.zeros(n, dtype=torch.bool),
                          adj, torch.ones((n, k), dtype=torch.int32),
                          torch.ones((n, k), dtype=torch.bool),
                          torch.ones(w, dtype=torch.bool), 5)
    assert (out[0][1:] == int(INF)).all()


def test_cpu_path_launches_no_kernel():
    """The launch counters move only where a CUDA kernel launches."""
    tkx.reset_launches()
    _port_ops(_inputs(np.random.default_rng(5), 8, 5, 2), 9)
    assert set(tkx.LAUNCHES.values()) == {0}


def test_cuda_request_without_a_card_raises(tmp_path):
    """No silent CPU path: asking for the card without one raises, an
    op refuses a device it has no kernel for, and a build without nvcc
    raises instead of returning something."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tkx.deliver_sweep(torch.empty((4, 3), dtype=torch.int32, **meta),
                          torch.empty((4, 3), dtype=torch.int32, **meta),
                          torch.empty(4, dtype=torch.bool, **meta),
                          torch.empty(3, dtype=torch.bool, **meta), 1)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library(nvcc=str(tmp_path / "no-nvcc"),
                             build_root=tmp_path)


def test_wrappers_check_their_inputs():
    iv = _t(_inputs(np.random.default_rng(9), 6, 5, 2))
    with pytest.raises(TypeError, match="int32"):
        tkx.deliver_sweep(iv["arr"].long(), iv["delivered"], iv["crashed"],
                          iv["is_app"], 1)
    with pytest.raises(ValueError, match="shape"):
        tkx.deliver_sweep(iv["arr"], iv["delivered"][:, :4],
                          iv["crashed"], iv["is_app"], 1)
    with pytest.raises(ValueError, match="contiguous"):
        tkx.retire_reduce(iv["arr"].t().contiguous().t(), iv["delivered"],
                          iv["crashed"], iv["min_gate"], 3)
