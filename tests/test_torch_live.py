"""The port's live serving front door (``repro_torch.core.vecsim.live`` and
``mode="live"`` of ``repro_torch.api``) on the CPU against the JAX
package's live loop on the numpy windowed engine.

* ``LiveReport`` fields, per-tick records, series, ``NetStats``,
  per-message aggregates, the delivered matrix, the latency histogram
  and the admitted scenario's arrays are byte-identical to the JAX live
  loop for {poisson, bursty} x {defer, shed};
* the capacity-blind ``admit`` policy overflows the window, is caught
  and retried, loses nothing, and still equals the reference;
* replaying ``admitted_scenario()`` through the port's batch windowed
  engine reproduces the live run;
* the ops plane's jsonl records equal the reference's;
* the front door and the command line serve, and live specs name the
  sharded engine as a streaming engine (its live runs are held against
  the reference in ``test_torch_shard_live.py``).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro.api as japi
from repro.core.vecsim.live import LiveLoop as JLiveLoop
from repro.core.vecsim.live import build_arrivals as j_build_arrivals
from repro.core.vecsim.scenario import churn_scenario as j_churn
from repro.core.vecsim.scenario import static_scenario as j_static
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.ops import OpsPlane as JOps
from repro.obs.spans import EngineObs as JObs
from repro_torch import api as tapi
from repro_torch.core.vecsim import (WindowOverflowError, execute_windowed,
                                     scenario_from_arrays)
from repro_torch.core.vecsim.live import (LiveColumnWindow, LiveLoop,
                                          build_arrivals)
from repro_torch.obs import (CausalAuditor, EngineObs, FlightRecorder,
                             OpsPlane, load_ops_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALL = ("wall_seconds", "requests_per_sec")


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def _pair(base, window, *, provenance=False, ops_dir=None, **kw):
    """(port report, reference report) of the same live run."""
    out = []
    for side in ("port", "jax"):
        if side == "port":
            obs = EngineObs(histograms=True, spans=True)
            if provenance:
                obs.flight = FlightRecorder(rate=1, sampler="all", live=True,
                                            auditor=CausalAuditor("fail"))
        else:
            obs = JObs(histograms=True, spans=True)
            if provenance:
                from repro.obs.audit import CausalAuditor as JAud
                obs.flight = JFlight(rate=1, sampler="all", live=True,
                                     auditor=JAud("fail"))
        ops = None
        if ops_dir is not None:
            plane = OpsPlane if side == "port" else JOps
            ops = plane(out=os.path.join(ops_dir, f"{side}.jsonl"),
                        sink="jsonl", every=2, slo_p99=20.0)
        if side == "port":
            loop = LiveLoop(port_scenario(base), window, device="cpu",
                            obs=obs, ops=ops, **kw)
        else:
            loop = JLiveLoop(base, window, engine="windowed",
                             backend="numpy", obs=obs, ops=ops, **kw)
        out.append((loop, loop.run()))
    return out


def _assert_live_identical(got, want):
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
    assert got.scenario.rounds == want.scenario.rounds
    a, b = got.result, want.result
    assert vars(a.stats) == vars(b.stats)
    for name in ("series", "deliv_count", "deliv_round_sum", "expired",
                 "bcast_done"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.delivered is None) == (b.delivered is None)
    if a.delivered is not None:
        np.testing.assert_array_equal(a.delivered, b.delivered)
    assert (a.peak_live, a.lat_sum, a.lat_cnt) == \
        (b.peak_live, b.lat_sum, b.lat_cnt)


@pytest.mark.parametrize("arrivals", ["poisson", "bursty"])
@pytest.mark.parametrize("admission", ["defer", "shed"])
def test_live_byte_identical_to_reference(arrivals, admission):
    (ploop, got), (jloop, want) = _pair(
        j_static(3, 64, k=4, m_app=0), 16, collect="full",
        provenance=True, arrivals=arrivals, admission=admission, rate=6.0,
        messages=240, queue_cap=48, seed=7,
        arrival_params=dict(period=64, duty=0.5))
    _assert_live_identical(got, want)
    np.testing.assert_array_equal(ploop.obs.latency_hist,
                                  jloop.obs.latency_hist)
    assert ploop.obs.flight.export() == jloop.obs.flight.export()
    assert ploop.obs.gauges == jloop.obs.gauges
    assert (got.admitted + got.shed_queue + got.shed_policy
            + got.unserved == got.offered)
    assert got.delivered_messages == got.admitted
    if admission == "shed":
        assert got.shed_queue + got.shed_policy > 0
    # the port names more phases than the JAX package (obs/spans.py);
    # the events both record come in the same order
    want = [e["name"] for e in jloop.obs.spans.events()]
    names = [e["name"] for e in ploop.obs.spans.events()
             if e["name"] in set(want)]
    assert names == want
    assert ploop.obs.spans.depth == 0


def test_admit_policy_overflows_is_caught_and_loses_nothing():
    (ploop, got), (_, want) = _pair(
        j_static(3, 64, k=4, m_app=0), 12, collect="full",
        provenance=True, arrivals="bursty", admission="admit", rate=8.0,
        messages=300, queue_cap=4096, seed=11,
        arrival_params=dict(period=64, duty=0.5))
    assert got.overflow_catches > 0 and ploop.requeued > 0
    assert got.admitted == got.delivered_messages == 300
    assert got.shed_queue == got.shed_policy == got.unserved == 0
    _assert_live_identical(got, want)
    bp = [e for e in ploop.obs.spans.events() if e["name"] == "backpressure"]
    assert len(bp) == got.overflow_catches


def test_live_with_churn_identical_to_reference():
    base = j_churn(17, 64, k=5, m_app=6, n_adds=5, n_rms=4)
    base = dataclasses.replace(base, bcast_round=np.empty(0, np.int32),
                               bcast_origin=np.empty(0, np.int32)).validate()
    (_, got), (_, want) = _pair(base, 24, collect="full", arrivals="poisson",
                                admission="defer", rate=3.0, messages=120,
                                queue_cap=1 << 12, seed=29)
    _assert_live_identical(got, want)


@pytest.mark.parametrize("admission", ["defer", "admit"])
def test_admitted_scenario_replays_through_the_batch_engine(admission):
    loop = LiveLoop(port_scenario(j_static(5, 64, k=4, m_app=0)), 16,
                    device="cpu", collect="full", arrivals="bursty",
                    admission=admission, rate=8.0, messages=200, seed=3,
                    arrival_params=dict(period=32, duty=0.5))
    rep = loop.run()
    res = execute_windowed(rep.scenario, 16, device="cpu", seg_len=32,
                           collect="full")
    np.testing.assert_array_equal(rep.result.delivered, res.delivered)
    np.testing.assert_array_equal(rep.result.series, res.series)
    np.testing.assert_array_equal(rep.result.deliv_count, res.deliv_count)
    np.testing.assert_array_equal(rep.result.deliv_round_sum,
                                  res.deliv_round_sum)
    assert rep.result.stats == res.stats


def test_ops_jsonl_records_match_reference(tmp_path):
    _pair(j_static(5, 48, k=4, m_app=0), 64, provenance=True,
          ops_dir=str(tmp_path), collect="full", arrivals="poisson",
          rate=4.0, messages=120, seed=3)
    got = load_ops_jsonl(str(tmp_path / "port.jsonl"))
    want = load_ops_jsonl(str(tmp_path / "jax.jsonl"))
    assert got and got == want
    assert got[-1]["provenance_completed"] > 0
    assert all(rec["audit_violations"] == 0 for rec in got)


# --------------------------------------------------------------------- #
# Window, arrivals, overflow
# --------------------------------------------------------------------- #
def test_arrivals_identical_to_reference():
    for kind in ("poisson", "bursty", "diurnal"):
        got = build_arrivals(kind, 3, 32, 4.0, 500, period=64)
        want = j_build_arrivals(kind, 3, 32, 4.0, 500, period=64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        build_arrivals("nope", 0, 8, 1.0, 10)


def test_live_window_append_withdraw_and_clean_overflow():
    scn = port_scenario(j_static(1, 16, k=4, m_app=0))
    cw = LiveColumnWindow(scn, 2, capacity=10)
    ids = cw.append_broadcasts(np.array([1, 1, 2], np.int32),
                               np.array([3, 4, 5], np.int32))
    assert ids.tolist() == [0, 1, 2] and cw.m_bc == 3
    with pytest.raises(ValueError):   # behind the admitted stream
        cw.append_broadcasts(np.array([1], np.int32),
                             np.array([9], np.int32))
    assert cw.activate(0, 8) == 2     # the third broadcast blocks at 2
    assert cw.next_bc == 2
    snap = (cw.slot_msg.copy(), cw.next_bc, cw.m_bc, cw.bc_round.copy())
    with pytest.raises(WindowOverflowError) as exc:
        cw.activate(2, 8)
    assert exc.value.round == 2
    np.testing.assert_array_equal(cw.slot_msg, snap[0])
    assert (cw.next_bc, cw.m_bc) == snap[1:3]
    np.testing.assert_array_equal(cw.bc_round, snap[3])
    rounds, origins = cw.withdraw_unactivated()
    assert rounds.tolist() == [2] and origins.tolist() == [5]
    assert cw.m_bc == 2
    with pytest.raises(ValueError):   # live base must be broadcast-free
        LiveColumnWindow(port_scenario(j_static(1, 16, m_app=2)), 8,
                         capacity=4)


# --------------------------------------------------------------------- #
# The front door and the command line
# --------------------------------------------------------------------- #
def _live_specs(**kw):
    d = dict(mode="live", n=64, seed=2, engine="windowed", **kw)
    return (japi.RunSpec.from_dict(dict(d, backend="numpy")),
            tapi.RunSpec.from_dict(dict(d, device="cpu")))


def test_api_live_matches_reference(tmp_path):
    cfg = dict(live=dict(arrivals="bursty", admission="defer", rate=6.0,
                         messages=150, queue_cap=1024, slo_p99=1e9,
                         period=64, duty=0.5),
               window=dict(window=24, seg_len=8, collect="full"),
               metrics=dict(oracle=True))
    jspec, tspec = _live_specs(**cfg)
    want, got = japi.run(jspec), tapi.run(tspec)
    assert got.device == "cpu" and got.engine == "windowed"
    assert got.live.slo_ok is True and got.oracle.ok
    assert (got.m_app, got.rounds, got.window) == \
        (want.m_app, want.rounds, want.window)
    assert vars(got.stats) == vars(want.stats)
    drop = ("serve_requests_per_sec",)
    assert {k: v for k, v in got.extras.items() if k not in drop} == \
        {k: v for k, v in want.extras.items() if k not in drop}
    assert got.extras["latency_hist_total"] == \
        int(got.result.deliv_count[: got.m_app].sum())
    d = got.to_dict()
    assert d["live"]["p99"] == got.live.p99
    json.dumps(d)


def test_live_spec_validation():
    assert tapi.RunSpec(mode="live", engine="sharded").validate().engine \
        == "sharded"
    with pytest.raises(tapi.SpecError, match="live.arrivals"):
        tapi.RunSpec(mode="live",
                     live=tapi.LiveSpec(arrivals="nope")).validate()
    with pytest.raises(tapi.SpecError, match="engine"):
        tapi.RunSpec(mode="live", engine="vec").validate()
    with pytest.raises(tapi.SpecError, match="per_round_cap"):
        tapi.RunSpec(mode="live", n=8,
                     live=tapi.LiveSpec(per_round_cap=9)).validate()
    with pytest.raises(tapi.SpecError, match="snapshot"):
        tapi.RunSpec(mode="live",
                     metrics=tapi.MetricsSpec(snapshot=4)).validate()
    with pytest.raises(tapi.SpecError):
        tapi.RunSpec(mode="serve").validate()
    # a reference live spec dict carries over, and round-trips
    d = japi.RunSpec(mode="live", live=japi.LiveSpec(arrivals="bursty",
                                                     rate=2.5)).to_dict()
    spec = tapi.RunSpec.from_dict(d).validate()
    assert spec.live.arrivals == "bursty" and spec.live.rate == 2.5
    assert tapi.RunSpec.from_dict(spec.to_dict()) == spec
    with pytest.raises(ValueError, match="sharded"):
        LiveLoop(port_scenario(j_static(1, 16, k=4, m_app=0)), 8,
                 engine="vec", device="cpu")


def test_discovery_lists_live_and_telemetry_registries():
    from repro_torch.api.__main__ import print_registries
    buf = io.StringIO()
    with redirect_stdout(buf):
        print_registries()
    out = buf.getvalue()
    for head in ("arrivals (live mode):", "admission (live mode):",
                 "sinks (--metrics-out formats):",
                 "samplers (--provenance policies):",
                 "audit (--audit modes):", "ops sinks (--ops-out formats):"):
        assert head in out, head
    for line in out.splitlines():
        if line.startswith("  "):
            key_desc = line.strip().split(None, 1)
            assert len(key_desc) == 2 and key_desc[1], line


def test_cli_serve_reports_json_with_telemetry(tmp_path):
    env = dict(os.environ, PYTHONPATH="src")
    trace, ops = tmp_path / "trace.json", tmp_path / "ops.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", "--device", "cpu",
         "--serve", "--n", "64", "--arrivals", "bursty", "--rate", "6",
         "--messages", "120", "--window", "24", "--seg-len", "8",
         "--provenance", "2", "--audit", "fail", "--trace-out", str(trace),
         "--ops-out", str(ops), "--ops-sink", "jsonl"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["device"] == "cpu" and rep["spec"]["mode"] == "live"
    assert rep["live"]["admitted"] == 120
    assert rep["extras"]["audit_violations"] == 0
    assert rep["extras"]["latency_hist_total"] > 0
    json.loads(trace.read_text())
    assert load_ops_jsonl(str(ops))
