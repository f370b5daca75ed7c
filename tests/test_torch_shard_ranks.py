"""The port's sharded engine over 2 and 4 CPU ranks (gloo), against the
JAX package's numpy windowed engine, byte for byte.

Each rank count spawns its ranks once (``torch_shard_ranks``) and runs
the whole batch there; the tests below read rank 0's results:

* every builder of ``vecsim_cases`` at N = 61 (not a multiple of the
  rank count: padding rows) and N = 256, ``scan`` on and off: delivered
  matrix, series, ``NetStats``, per-message aggregates, peak, latency
  sums and final state;
* overflow-round parity on half-width windows; horizon expiry,
  aggregate collection and the snapshot;
* the latency histogram, the gauges and sampled provenance of every
  message.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.vecsim import WindowOverflowError as RefOverflow
from repro.core.vecsim.stream import execute_windowed as ref_windowed
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.spans import EngineObs as JObs
from repro_torch.core.vecsim import scenario_from_arrays
from torch_shard_ranks import run_on_ranks
from vecsim_cases import BUILDERS

NS = (61, 256)
SCANS = ("on", "off")
OVERFLOW = ("churn", "sustained_kreg", "waves")
TELEMETRY = ("churn", "sustained_sw")


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def _ref(key):
    """The reference scenario, window and engine keywords of a case."""
    kind = key[0]
    if kind == "matrix":
        _, name, n, scan = key
        ref = BUILDERS[name](5, n)
        return ref, ref.m_total, dict(collect="full", seg_len=16)
    if kind == "overflow":
        ref = BUILDERS[key[1]](5, 64)
        return ref, max(4, ref.m_total // 2), dict(collect="full",
                                                   seg_len=8)
    if kind == "horizon":
        ref = BUILDERS["churn"](13, 63)
        return ref, ref.m_total, dict(horizon=6, seg_len=8, collect="full")
    if kind == "aggregate":
        ref = BUILDERS["churn"](13, 63)
        return ref, ref.m_total, dict(seg_len=8, collect="aggregate")
    if kind == "snapshot":
        ref = BUILDERS["churn"](13, 63)
        return ref, ref.m_total, dict(seg_len=8, collect="full",
                                      snapshot_round=int(ref.add_round[-1]))
    ref = BUILDERS[key[1]](4, 94)
    return ref, ref.m_total, dict(seg_len=4, collect="full")


def _keys():
    keys = [("matrix", name, n, scan) for name in sorted(BUILDERS)
            for n in NS for scan in SCANS]
    keys += [("overflow", name) for name in OVERFLOW]
    keys += [("horizon",), ("aggregate",), ("snapshot",)]
    keys += [("telemetry", name) for name in TELEMETRY]
    return keys


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(rank count, {case key: rank 0's result}) — one spawn a count."""
    world = request.param
    keys = _keys()
    cases = []
    for key in keys:
        ref, w, kw = _ref(key)
        scan = key[3] if key[0] == "matrix" else "on"
        cases.append(("batch", port_scenario(ref), w, dict(kw, scan=scan),
                      key[0] == "telemetry"))
    out = run_on_ranks(world, tmp_path_factory.mktemp(f"ranks{world}"),
                       cases)
    return world, dict(zip(keys, out))


def _check(world, key, got):
    ref, w, kw = _ref(key)
    try:
        want = ref_windowed(ref, w, backend="numpy", **kw)
    except RefOverflow as exc:
        assert got == dict(overflow=exc.round), key
        return None
    res = got["result"]
    assert res.n_devices == world and res.device == "cpu"
    full = kw["collect"] == "full"
    if full:
        np.testing.assert_array_equal(res.delivered, want.delivered)
    else:
        assert res.delivered is None and want.delivered is None
    np.testing.assert_array_equal(res.series, want.series)
    assert vars(res.stats) == vars(want.stats)
    for name in ("deliv_count", "deliv_round_sum", "bcast_done", "expired"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(want, name), err_msg=name)
    assert res.peak_live == want.peak_live
    assert (res.lat_sum, res.lat_cnt) == (want.lat_sum, want.lat_cnt)
    for name in want.state:
        np.testing.assert_array_equal(res.state[name], want.state[name],
                                      err_msg=name)
    return res, want


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_sharded_ranks_byte_identical_to_numpy(ranks, builder, n, scan):
    world, out = ranks
    key = ("matrix", builder, n, scan)
    got = _check(world, key, out[key])
    assert got is not None
    res = got[0]
    if scan == "off":
        assert res.fast_segments == 0
    if n % world:
        assert res.state["arr"].shape[0] == n     # padding sliced off


@pytest.mark.parametrize("builder", OVERFLOW)
def test_overflow_parity_on_ranks(ranks, builder):
    world, out = ranks
    _check(world, ("overflow", builder), out[("overflow", builder)])


def test_horizon_aggregate_and_snapshot_on_ranks(ranks):
    world, out = ranks
    res, want = _check(world, ("horizon",), out[("horizon",)])
    assert want.expired.any()
    _check(world, ("aggregate",), out[("aggregate",)])
    res, want = _check(world, ("snapshot",), out[("snapshot",)])
    for name in want.snapshot:
        np.testing.assert_array_equal(res.snapshot[name],
                                      want.snapshot[name], err_msg=name)


@pytest.mark.parametrize("builder", TELEMETRY)
def test_histogram_and_provenance_on_ranks(ranks, builder):
    world, out = ranks
    key = ("telemetry", builder)
    got = out[key]
    _check(world, key, got)
    ref, w, kw = _ref(key)
    jobs = JObs(histograms=True)
    jobs.flight = JFlight(rate=1, seed=0, sampler="all")
    ref_windowed(ref, w, backend="numpy", obs=jobs, **kw)
    np.testing.assert_array_equal(got["hist"], jobs.latency_hist)
    assert got["hist"].sum() > 0
    assert got["flight"] == jobs.flight.export() and got["flight"]
    assert got["gauges"] == jobs.gauges
