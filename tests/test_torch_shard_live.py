"""Live serving on the port's sharded engine
(``LiveLoop(engine="sharded")``, ``mode="live"`` of ``repro_torch.api``)
on the CPU, against the JAX package's live loop on the numpy windowed
engine, byte for byte, at one rank (in process) and two gloo ranks (one
spawn for the whole batch):

* ``LiveReport`` fields, per-tick records, series, ``NetStats``,
  per-message aggregates, the delivered matrix, the latency histogram,
  the provenance of every message under the fail-mode audit, and the
  admitted scenario, for {poisson, bursty} x {defer, shed};
* the capacity-blind ``admit`` policy overflowing the window and being
  caught, on a churn base;
* the front door serving through the sharded engine.
"""

import dataclasses

import numpy as np
import pytest

import repro.api as japi
from repro.core.vecsim.live import LiveLoop as JLiveLoop
from repro.core.vecsim.scenario import churn_scenario as j_churn
from repro.core.vecsim.scenario import static_scenario as j_static
from repro.obs.audit import CausalAuditor as JAuditor
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.spans import EngineObs as JObs
from repro_torch import api as tapi
from repro_torch.core.vecsim import scenario_from_arrays
from torch_shard_ranks import _run_case, run_on_ranks

_WALL = ("wall_seconds", "requests_per_sec")

CASES = [(arrivals, admission) for arrivals in ("poisson", "bursty")
         for admission in ("defer", "shed")]


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def _case(arrivals, admission):
    """(reference base scenario, window, LiveLoop keywords)."""
    if admission == "admit":
        base = j_churn(17, 64, k=5, m_app=6, n_adds=5, n_rms=4)
        base = dataclasses.replace(
            base, bcast_round=np.empty(0, np.int32),
            bcast_origin=np.empty(0, np.int32)).validate()
        return (base, 14,
                dict(collect="full", arrivals="bursty", admission="admit",
                     rate=8.0, messages=150, seed=11, seg_len=8,
                     arrival_params=dict(period=64, duty=0.5)))
    return (j_static(3, 64, k=4, m_app=0), 16,
            dict(collect="full", arrivals=arrivals, admission=admission,
                 rate=6.0, messages=240, queue_cap=48, seed=7,
                 arrival_params=dict(period=64, duty=0.5)))


def _reference(arrivals, admission):
    base, window, kw = _case(arrivals, admission)
    obs = JObs(histograms=True, spans=True)
    obs.flight = JFlight(rate=1, sampler="all", live=True,
                         auditor=JAuditor("fail"))
    rep = JLiveLoop(base, window, engine="windowed", backend="numpy",
                    obs=obs, **kw).run()
    return rep, obs


def _port_case(arrivals, admission):
    base, window, kw = _case(arrivals, admission)
    return ("live", port_scenario(base), window, kw, True)


def _assert_live_identical(got, want, hist, jobs, flight):
    dg, dw = got.to_dict(), want.to_dict()
    for key in _WALL:
        dg.pop(key)
        dw.pop(key)
    assert dg == dw
    assert got.ticks == want.ticks
    np.testing.assert_array_equal(got.latency_rounds, want.latency_rounds)
    np.testing.assert_array_equal(got.submit_round, want.submit_round)
    for name in ("bcast_round", "bcast_origin", "add_round", "rm_round",
                 "crash_round"):
        np.testing.assert_array_equal(getattr(got.scenario, name),
                                      getattr(want.scenario, name))
    a, b = got.result, want.result
    assert vars(a.stats) == vars(b.stats)
    for name in ("series", "deliv_count", "deliv_round_sum", "expired",
                 "bcast_done", "delivered"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.peak_live, a.lat_sum, a.lat_cnt) == \
        (b.peak_live, b.lat_sum, b.lat_cnt)
    np.testing.assert_array_equal(hist, jobs.latency_hist)
    assert flight == jobs.flight.export() and flight


@pytest.mark.parametrize("arrivals,admission",
                         CASES + [("poisson", "admit")])
def test_sharded_live_world1_identical_to_reference(arrivals, admission):
    got = _run_case(_port_case(arrivals, admission))
    want, jobs = _reference(arrivals, admission)
    rep = got["report"]
    assert rep.result.n_devices == 1
    _assert_live_identical(rep, want, got["hist"], jobs, got["flight"])
    if admission == "admit":
        assert rep.overflow_catches > 0


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Rank 0's live reports of every case on two gloo ranks."""
    cases = CASES + [("poisson", "admit")]
    out = run_on_ranks(2, tmp_path_factory.mktemp("live2"),
                       [_port_case(*c) for c in cases])
    return dict(zip(cases, out))


@pytest.mark.parametrize("arrivals,admission",
                         CASES + [("poisson", "admit")])
def test_sharded_live_two_ranks_identical_to_reference(two_ranks, arrivals,
                                                       admission):
    got = two_ranks[(arrivals, admission)]
    want, jobs = _reference(arrivals, admission)
    assert got["report"].result.n_devices == 2
    _assert_live_identical(got["report"], want, got["hist"], jobs,
                           got["flight"])


def test_front_door_serves_through_the_sharded_engine():
    d = dict(mode="live", n=64, seed=2,
             live=dict(arrivals="bursty", admission="defer", rate=6.0,
                       messages=150, queue_cap=1024, slo_p99=1e9,
                       period=64, duty=0.5),
             window=dict(window=24, seg_len=8, collect="full"),
             metrics=dict(oracle=True), obs=dict(provenance=2, audit="fail"))
    want = japi.run(japi.RunSpec.from_dict(dict(d, engine="windowed",
                                                 backend="numpy")))
    got = tapi.run(tapi.RunSpec.from_dict(
        dict(d, engine="sharded", device="cpu",
             shard=dict(devices=1, scan="on"))))
    assert got.engine == "sharded" and got.device == "cpu"
    assert got.oracle.ok and got.live.slo_ok is True
    assert vars(got.stats) == vars(want.stats)
    # the sharded engine adds its stager's counters, as the JAX one does
    assert got.extras["stager_uploads"] > 0 and got.extras["stager_skips"]
    drop = ("serve_requests_per_sec", "stager_uploads", "stager_skips")
    assert {k: v for k, v in got.extras.items() if k not in drop} == \
        {k: v for k, v in want.extras.items() if k not in drop}
    assert got.obs.flight.export() == want.obs.flight.export()
