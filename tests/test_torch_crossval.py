"""The port's cross-validation harness and its front door, on the CPU:
``cross_validate(..., device="cpu")`` — the vec or windowed engine of
the port against the port's exact event engine — on the scenarios of
``tests/test_vecsim.py`` (static, link_add and churn at N in {64, 256},
and the sustained, churn-wave and partition-heal builders), with both
multisets equal to each other and to the JAX package's and both oracle
reports clean; the harness's own sanity (a lost delivery breaks the
equality); ``run(RunSpec(metrics=MetricsSpec(crossval=True)))`` on the
vec, windowed, sharded (one rank and two spawned gloo ranks) and live
engines; ``engine="exact"``
through the front door against the JAX package's report; and the
command line's ``--crossval``."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repro.api as japi
from repro.core.vecsim import crossval as jcv
from repro_torch import api as tapi
from repro.core.vecsim import scenario as jscn
from repro_torch.core.vecsim import (churn_scenario, cross_validate,
                                     delivered_multiset, link_add_scenario,
                                     static_scenario)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIOS = {
    "static": (static_scenario, jscn.static_scenario),
    "link_add": (link_add_scenario, jscn.link_add_scenario),
    "churn": (churn_scenario, jscn.churn_scenario),
}


def _check(out, want, n_expected=None):
    assert out["vec_multiset"] == out["exact_multiset"]
    assert out["vec_multiset"] == want["vec_multiset"] == \
        want["exact_multiset"]
    if n_expected is not None:
        assert len(out["vec_multiset"]) == n_expected
    assert out["vec_report"].ok, out["vec_report"].summary()
    assert out["exact_report"].ok, out["exact_report"].summary()
    assert out["vec_report"].summary() == want["vec_report"].summary()
    assert out["exact_report"].summary() == want["exact_report"].summary()


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_vec_matches_exact_engine(name, n):
    port_b, ref_b = SCENARIOS[name]
    scn = port_b(seed=n + 17, n=n)
    out = cross_validate(scn, device="cpu")
    assert out["vec"].device == "cpu"
    _check(out, jcv.cross_validate(ref_b(seed=n + 17, n=n)),
           n_expected=n * scn.m_app)


@pytest.mark.parametrize("name,builders", [
    ("sustained", (lambda m: m.sustained_scenario(
        seed=11, n=64, k=6, rate=2.0, messages=30, max_delay=2))),
    ("waves", (lambda m: m.churn_wave_scenario(seed=11, n=64, waves=3))),
    ("partition", (lambda m: m.partition_heal_scenario(
        seed=11, n=64, traffic_during_partition=True))),
])
def test_new_builders_cross_validate_against_exact_engine(name, builders):
    import repro_torch.core.vecsim as tvec
    out = cross_validate(builders(tvec), device="cpu")
    _check(out, jcv.cross_validate(builders(jscn)))
    assert out["vec"].delivered_frac() == 1.0


def test_crossval_catches_a_lost_delivery():
    """Sanity of the harness itself: corrupting one delivery breaks
    multiset equality."""
    out = cross_validate(static_scenario(seed=0, n=64), device="cpu")
    res = out["vec"]
    assert delivered_multiset(res) == out["exact_multiset"]
    res.delivered[7, 0] = -1
    assert delivered_multiset(res) != out["exact_multiset"]


@pytest.mark.parametrize("name,build,window", [
    ("churn", lambda m: m.churn_scenario(seed=21, n=96), None),
    ("sustained", lambda m: m.sustained_scenario(
        seed=21, n=96, k=5, rate=3.0, messages=60, max_delay=2), 40),
])
def test_windowed_cross_validation(name, build, window):
    import repro_torch.core.vecsim as tvec
    scn = build(tvec)
    window = scn.m_total if window is None else window
    out = cross_validate(scn, device="cpu", window=window)
    assert out["vec"].window == window and out["vec"].delivered is not None
    _check(out, jcv.cross_validate(build(jscn), window=window))
    # the same result reused as the vec side skips its re-execution
    again = cross_validate(scn, device="cpu", vec_result=out["vec"])
    assert again["vec"] is out["vec"]
    assert again["vec_multiset"] == again["exact_multiset"]


def _crossval_spec(**kw):
    return tapi.RunSpec(device="cpu", n=kw.pop("n", 64), seed=3,
                        metrics=tapi.MetricsSpec(crossval=True, oracle=True),
                        **kw)


@pytest.mark.parametrize("case", ["vec", "windowed", "sharded",
                                  "sharded_two_ranks", "windowed_aggregate",
                                  "live"])
def test_run_crossval_on_every_engine(case):
    dyn = tapi.DynamicsSpec(kind="churn")
    if case == "vec":
        spec = _crossval_spec(engine="vec", dynamics=dyn)
    elif case == "windowed":
        spec = _crossval_spec(engine="windowed", dynamics=dyn,
                              window=tapi.WindowSpec(window=64,
                                                     collect="full"))
    elif case == "windowed_aggregate":
        # no delivered matrix on the run: the vec side runs again on
        # the windowed engine with it collected
        spec = dataclasses.replace(
            _crossval_spec(engine="windowed", dynamics=dyn,
                           window=tapi.WindowSpec(window=64,
                                                  collect="aggregate")),
            metrics=tapi.MetricsSpec(crossval=True))
    elif case.startswith("sharded"):
        # two ranks: the front door spawns them (gloo), and rank 0, which
        # holds the gathered delivered matrix, cross-validates
        spec = _crossval_spec(engine="sharded", dynamics=dyn,
                              shard=tapi.ShardSpec(
                                  devices=2 if case.endswith("ranks")
                                  else 1),
                              window=tapi.WindowSpec(window=64,
                                                     collect="full"))
    else:
        spec = _crossval_spec(mode="live", live=tapi.LiveSpec(
            rate=2.0, messages=40), window=tapi.WindowSpec(
            window=24, seg_len=4, collect="full"))
    rep = tapi.run(spec)
    assert rep.crossval_ok is True
    assert rep.to_dict()["crossval_ok"] is True
    assert rep.engine == ("windowed" if case.startswith("windowed")
                          or case == "live" else case.split("_")[0])
    if rep.oracle is not None:
        assert rep.oracle.ok
    if case == "live":
        assert rep.live.delivered_frac == 1.0


@pytest.mark.parametrize("proto,dyn", [("pc", "churn"), ("r", "none"),
                                       ("pc", "crash"), ("vc", "link_add")])
def test_exact_engine_report_equals_reference(proto, dyn):
    kw = dict(protocol=proto, engine="exact", n=48, seed=4)
    want = japi.run(japi.RunSpec(
        backend="numpy", **kw, dynamics=japi.DynamicsSpec(kind=dyn),
        metrics=japi.MetricsSpec(oracle=True, crossval=True)))
    got = tapi.run(tapi.RunSpec(
        device="cpu", **kw, dynamics=tapi.DynamicsSpec(kind=dyn),
        metrics=tapi.MetricsSpec(oracle=True, crossval=True)))
    assert (got.engine, got.device, got.window) == ("exact", "object", None)
    assert (got.n, got.m_app, got.rounds) == (want.n, want.m_app,
                                              want.rounds)
    assert vars(got.stats) == vars(want.stats)
    assert got.delivered_frac == want.delivered_frac
    assert got.mean_latency == want.mean_latency
    assert got.extras == want.extras
    assert got.oracle.summary() == want.oracle.summary()
    assert got.oracle.ok == want.oracle.ok
    assert got.crossval_ok is want.crossval_ok is True
    d = got.to_dict()
    assert d["device"] == "object" and d["crossval_ok"] is True


def test_exact_engine_is_never_auto_selected():
    spec = tapi.RunSpec(device="cpu", n=32).validate()
    assert tapi.select_engine(spec, tapi.build_scenario(spec))[0] != "exact"
    with pytest.raises(tapi.SpecError, match="monolithic/exact"):
        tapi.RunSpec(engine="exact",
                     window=tapi.WindowSpec(window=8)).validate()
    with pytest.raises(tapi.SpecError, match="only applies"):
        tapi.RunSpec(engine="exact",
                     shard=tapi.ShardSpec(devices=1)).validate()


def test_cli_crossval():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", "--device", "cpu",
         "--n", "96", "--dynamics", "churn", "--messages", "12",
         "--oracle", "--crossval"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["crossval_ok"] is True and rep["oracle_ok"] is True
    assert rep["spec"]["metrics"]["crossval"] is True
