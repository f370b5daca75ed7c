"""The port's vector-clock baseline (``repro_torch.core.vecsim.vc``,
torch) on the CPU against the JAX package's numpy ``run_vec_vc``: every
field byte-equal on every scenario builder at N in {64, 256}, on a
schedule with two broadcasts by one origin in the same round and on an
out-of-order arrival that parks a message; the ``vc`` arm of the
cross-validation (clocks equal to the exact engine's); the front door's
extras against the reference's and its refusals mirrored; and the Fig. 7
metric functions of ``core.vecsim.metrics`` against the reference's on
monolithic and windowed snapshots."""

import dataclasses

import numpy as np
import pytest

import repro.api as japi
from repro.core.vecsim import metrics as jmetrics
from repro.core.vecsim.crossval import cross_validate as ref_cross_validate
from repro.core.vecsim.sim import execute_vec as ref_execute_vec
from repro.core.vecsim.stream import execute_windowed as ref_windowed
from repro.core.vecsim.vc import run_vec_vc as ref_run_vec_vc
from repro_torch import api as tapi
from repro_torch.core.vecsim import (cross_validate, execute_vec,
                                     execute_windowed, run_vec_vc,
                                     scenario_from_arrays)
from repro_torch.core.vecsim import metrics as tmetrics
from vecsim_cases import BUILDERS

ARRAYS = ("delivered", "rcv", "vc", "origins", "stamp", "series")


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def assert_vc_equal(got, want):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert sorted(got.state) == sorted(want.state)
    for key in want.state:
        assert got.state[key].dtype == want.state[key].dtype, key
        np.testing.assert_array_equal(got.state[key], want.state[key],
                                      err_msg=key)
    assert vars(got.stats) == vars(want.stats)
    assert (got.comparisons, got.max_pending) == (want.comparisons,
                                                  want.max_pending)
    assert type(got.comparisons) is int and type(got.max_pending) is int
    assert got.final_clocks() == want.final_clocks()
    assert got.delivered_frac() == want.delivered_frac()
    assert got.overhead_bytes_per_message() == \
        want.overhead_bytes_per_message()
    assert got.comparisons_per_delivery() == want.comparisons_per_delivery()


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("n", [64, 256])
def test_run_vec_vc_byte_equal(builder, n):
    ref = BUILDERS[builder](5, n)
    got = run_vec_vc(port_scenario(ref), device="cpu")
    assert got.device == "cpu"
    assert got.drain_iters.shape == (ref.rounds,)
    assert_vc_equal(got, ref_run_vec_vc(ref))


def _scenario(n, k, adj0, delay0, **kw):
    from repro.core.vecsim import VecScenario
    return VecScenario(n=n, k=k, rounds=30, adj0=adj0, delay0=delay0,
                       **kw).validate()


def i32(*a):
    return np.asarray(a, np.int32)


def test_same_round_broadcasts_by_one_origin():
    """Two broadcasts by one origin in one round: the second stamps the
    first's increment (the broadcasts run one after another).  The
    scenario validator refuses such a schedule (the exact engine's
    per-origin counters would diverge), so the case is built valid with
    scenario_from_arrays and given its duplicate afterwards."""
    from repro.core.vecsim import VecScenario
    fields = dict(n=6, k=2, rounds=24, mode="pc",
                  adj0=np.stack([(np.arange(6) + 1) % 6,
                                 (np.arange(6) + 3) % 6], 1).astype(np.int32),
                  delay0=np.ones((6, 2), np.int32),
                  bcast_round=i32(0, 2, 2, 3, 5, 5),
                  bcast_origin=i32(1, 3, 4, 3, 3, 0))
    dup = dict(bcast_round=i32(0, 2, 2, 2, 5, 5))
    got = run_vec_vc(dataclasses.replace(scenario_from_arrays(fields),
                                         **dup), device="cpu")
    want = ref_run_vec_vc(dataclasses.replace(
        VecScenario(**fields).validate(), **dup))
    assert_vc_equal(got, want)
    col = int(np.searchsorted(got.origins, 3))
    assert got.stamp[1, col] == 1 and got.stamp[3, col] == 2
    assert got.delivered_frac() == 1.0


def test_out_of_order_arrival_parks_and_drains():
    """``tests/test_api.py``'s out-of-order case: m2 overtakes m1 on a
    fresh fast link and waits in pending for it."""
    n, k = 3, 3
    adj0 = np.full((n, k), -1, np.int32)
    delay0 = np.ones((n, k), np.int32)
    adj0[0, 0] = 1
    adj0[0, 1], delay0[0, 1] = 2, 9
    adj0[1, 0] = 0
    adj0[2, 0] = 0
    ref = _scenario(n, k, adj0, delay0, bcast_round=i32(0, 6),
                    bcast_origin=i32(0, 1), add_round=i32(5),
                    add_p=i32(1), add_k=i32(2), add_q=i32(2),
                    add_delay=i32(1))
    got = run_vec_vc(port_scenario(ref), device="cpu")
    assert_vc_equal(got, ref_run_vec_vc(ref))
    assert got.max_pending >= 2
    assert got.rcv[2, 1] < got.rcv[2, 0] <= got.delivered[2, 1]


@pytest.mark.parametrize("builder", ["static", "churn", "crash",
                                     "partition"])
def test_vc_cross_validation_clocks(builder):
    ref = BUILDERS[builder](9, 64)
    out = cross_validate(port_scenario(ref), device="cpu", protocol="vc")
    want = ref_cross_validate(ref, protocol="vc")
    assert out["vec_multiset"] == out["exact_multiset"] == \
        want["exact_multiset"]
    assert out["vec_clocks"] == out["exact_clocks"] == want["exact_clocks"]
    assert out["vec_report"].ok and out["exact_report"].ok
    with pytest.raises(ValueError, match="no windowed mode"):
        cross_validate(port_scenario(ref), device="cpu", protocol="vc",
                       window=8)


@pytest.mark.parametrize("engine,messages", [("vec", 4), ("vec", 32),
                                             ("exact", 12), ("auto", 12)])
def test_vc_run_extras_equal_reference(engine, messages):
    kw = dict(protocol="vc", engine=engine, n=64, seed=2)
    want = japi.run(japi.RunSpec(backend="numpy", **kw,
                                 traffic=japi.TrafficSpec(messages=messages)))
    got = tapi.run(tapi.RunSpec(device="cpu", **kw,
                                traffic=tapi.TrafficSpec(messages=messages)))
    assert got.engine == want.engine
    assert got.device == ("object" if want.engine == "exact" else "cpu")
    assert sorted(got.extras) == sorted(want.extras) == [
        "comparisons_per_delivery", "max_pending",
        "overhead_bytes_per_msg", "space_entries_max"]
    assert got.extras == want.extras
    assert vars(got.stats) == vars(want.stats)
    assert got.delivered_frac == want.delivered_frac
    assert got.mean_latency == want.mean_latency


@pytest.mark.parametrize("kw,match", [
    (dict(engine="windowed"), "no windowed engine"),
    (dict(engine="sharded"), "no windowed engine"),
    (dict(window=tapi.WindowSpec(window=16)), "no windowed engine"),
    (dict(mode="live"), "windowed protocol"),
])
def test_vc_refusals_mirror_reference(kw, match):
    with pytest.raises(tapi.SpecError, match=match):
        tapi.RunSpec(protocol="vc", device="cpu", **kw).validate()


def test_vc_snapshot_and_sharded_runner_refused():
    spec = tapi.RunSpec(protocol="vc", device="cpu", engine="vec",
                        dynamics=tapi.DynamicsSpec(kind="churn"),
                        metrics=tapi.MetricsSpec(snapshot="last_churn"))
    with pytest.raises(tapi.SpecError, match="snapshot"):
        tapi.run(spec)
    from repro_torch.api.run import _run_sharded
    scn = tapi.build_scenario(dataclasses.replace(spec, metrics=tapi.MetricsSpec()))
    with pytest.raises(tapi.SpecError, match="no sharded engine"):
        _run_sharded(spec, scn, 8, None, "cpu")


def test_auto_never_windowed_for_vc():
    kw = dict(protocol="vc", n=2000, memory_budget_mb=1)
    port = tapi.RunSpec(device="cpu", **kw, traffic=tapi.TrafficSpec(
        kind="poisson", rate=3.0, messages=500)).validate()
    ref = japi.RunSpec(**kw, traffic=japi.TrafficSpec(
        kind="poisson", rate=3.0, messages=500)).validate()
    assert tapi.select_engine(port, tapi.build_scenario(port)) == \
        japi.select_engine(ref, japi.build_scenario(ref)) == ("vec", None)


def _snapshots(builder):
    ref = BUILDERS[builder](4, 96)
    snap = int(ref.add_round[-1]) if ref.n_adds else ref.rounds // 2
    port = port_scenario(ref)
    w = ref.m_total
    return ref, snap, [
        (ref_execute_vec(ref, backend="numpy", snapshot_round=snap),
         execute_vec(port, device="cpu", snapshot_round=snap)),
        (ref_windowed(ref, w, backend="numpy", collect="full",
                      snapshot_round=snap),
         execute_windowed(port, w, device="cpu", collect="full",
                          snapshot_round=snap))]


@pytest.mark.parametrize("builder", ["link_add", "churn", "crash", "waves"])
def test_fig7_metrics_equal_reference(builder):
    ref, snap, pairs = _snapshots(builder)
    srcs = list(range(0, ref.n, 7))
    for want_res, got_res in pairs:
        for want, got in ((want_res.snapshot, got_res.snapshot),
                          (want_res.state, got_res.state)):
            for fn in ("safe_out_mask", "full_out_mask"):
                np.testing.assert_array_equal(getattr(tmetrics, fn)(got),
                                              getattr(jmetrics, fn)(want))
            for mask_fn in ("safe_out_mask", "full_out_mask"):
                args = lambda m, st: (st["adj"],  # noqa: E731
                                      getattr(m, mask_fn)(st), srcs)
                for kw in ({}, dict(unreachable_penalty=ref.n,
                                    exclude=want["crashed"])):
                    assert tmetrics.mean_shortest_path_vec(
                        *args(tmetrics, got), **kw) == \
                        jmetrics.mean_shortest_path_vec(
                            *args(jmetrics, want), **kw)
            assert tmetrics.unsafe_link_stats_vec(got, snap, ref.m_app) == \
                jmetrics.unsafe_link_stats_vec(want, snap, ref.m_app)
    mono_ref, mono_port = pairs[0]
    assert tmetrics.vc_overhead_model(mono_port) == \
        jmetrics.vc_overhead_model(mono_ref)
