"""The port's front door (``repro_torch.api``) on the CPU against the JAX
package's ``repro.api.run`` with the numpy backend, both with telemetry
at its defaults: engine selection, stats, delivered fraction, latency,
extras (the latency percentiles of windowed runs included) and the
oracle; ``RunSpec.from_dict`` on the reference's spec dicts, the
``shard`` section accepted and what is not ported yet refused; engine
auto-selection with ranks; the sharded engine through the front door
(one rank in process, two spawned gloo ranks) against the reference's
windowed engine; and the command line."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repro.api as japi
from repro_torch import api as tapi
from repro_torch.backend import cuda_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SECTIONS = ("topology", "traffic", "dynamics", "window", "metrics")


def _pair(**kw):
    """(reference spec, port spec) for the same experiment."""
    sect = {name: kw.pop(name) for name in SECTIONS if name in kw}
    ref = japi.RunSpec(backend="numpy",
                       **{name: getattr(japi, type(v).__name__)(
                           **dataclasses.asdict(v))
                          for name, v in sect.items()}, **kw)
    port = tapi.RunSpec(device="cpu", **sect, **kw)
    return ref, port


CASES = {
    "churn_vec_oracle": dict(
        n=64, seed=1, dynamics=tapi.DynamicsSpec(kind="churn"),
        traffic=tapi.TrafficSpec(messages=12),
        metrics=tapi.MetricsSpec(oracle=True, snapshot="last_churn")),
    "sustained_windowed_oracle": dict(
        n=96, seed=2, engine="windowed",
        topology=tapi.TopologySpec(kind="kregular", k=5, max_delay=2),
        traffic=tapi.TrafficSpec(kind="poisson", rate=3.0, messages=60),
        window=tapi.WindowSpec(window=40, seg_len=4, collect="full"),
        metrics=tapi.MetricsSpec(oracle=True)),
    "auto_windowed_by_budget": dict(
        n=512, seed=3, memory_budget_mb=1,
        topology=tapi.TopologySpec(kind="kregular", k=6, max_delay=1),
        traffic=tapi.TrafficSpec(kind="poisson", rate=16.0, messages=400),
        window=tapi.WindowSpec(seg_len=8)),
    "r_link_add": dict(
        protocol="r", n=64, seed=4,
        dynamics=tapi.DynamicsSpec(kind="link_add")),
    "crash_always_gate": dict(
        n=64, seed=5, always_gate=True,
        dynamics=tapi.DynamicsSpec(kind="crash"),
        metrics=tapi.MetricsSpec(oracle=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_report_matches_reference(case):
    ref_spec, port_spec = _pair(**dict(CASES[case]))
    want = japi.run(ref_spec)
    got = tapi.run(port_spec)
    assert got.device == "cpu"
    assert (got.engine, got.window) == (want.engine, want.window)
    assert (got.n, got.m_app, got.rounds) == (want.n, want.m_app,
                                              want.rounds)
    assert vars(got.stats) == vars(want.stats)
    assert got.delivered_frac == want.delivered_frac
    assert got.mean_latency == want.mean_latency
    assert got.extras == want.extras
    if want.oracle is None:
        assert got.oracle is None
    else:
        assert got.oracle.ok == want.oracle.ok
        assert got.oracle.summary() == want.oracle.summary()
    json.dumps(got.to_dict())


def test_select_engine_matches_reference():
    for case in sorted(CASES):
        ref_spec, port_spec = _pair(**dict(CASES[case]))
        want = japi.select_engine(ref_spec, japi.build_scenario(ref_spec))
        got = tapi.select_engine(port_spec, tapi.build_scenario(port_spec))
        assert got == want, case


def test_from_dict_accepts_reference_dicts():
    for case in sorted(CASES):
        ref_spec, port_spec = _pair(**dict(CASES[case]))
        got = tapi.RunSpec.from_dict(ref_spec.to_dict())
        assert got == dataclasses.replace(port_spec, device=None), case
    assert tapi.RunSpec.from_dict(japi.RunSpec().to_dict()) == \
        tapi.RunSpec()
    d = japi.RunSpec(backend="jax").to_dict()
    d["device"] = "cpu"
    assert tapi.RunSpec.from_dict(d).device == "cpu"


def test_unported_defaults_track_the_reference():
    from repro_torch.api.spec import _LATER_VALUES
    assert set(_LATER_VALUES) == {("protocol", "vc"), ("engine", "exact")}
    # the ported shard, live and obs sections keep the reference's
    # defaults
    for port_cls, cls in ((tapi.ShardSpec, japi.ShardSpec),
                          (tapi.LiveSpec, japi.LiveSpec),
                          (tapi.ObsSpec, japi.ObsSpec)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(cls())


@pytest.mark.parametrize("ref_kw", [
    dict(shard=japi.ShardSpec(devices=2), engine="sharded"),
    dict(shard=japi.ShardSpec(scan="on")),
    dict(mode="live", engine="sharded"),
    dict(mode="live", shard=japi.ShardSpec(devices=4)),
    dict(shard=japi.ShardSpec(profile=True), engine="sharded"),
    dict(shard=japi.ShardSpec(devices=1, scan="off", profile=True),
         engine="sharded", window=japi.WindowSpec(window=16)),
])
def test_from_dict_accepts_shard_section(ref_kw):
    spec = tapi.RunSpec.from_dict(japi.RunSpec(**ref_kw).to_dict())
    spec.validate()
    want = ref_kw.get("shard", japi.ShardSpec())
    assert dataclasses.asdict(spec.shard) == dataclasses.asdict(want)
    assert tapi.RunSpec.from_dict(spec.to_dict()) == spec


@pytest.mark.parametrize("ref_kw,match", [
    (dict(mode="live", metrics=japi.MetricsSpec(crossval=True)),
     "exact-engine slice"),
    (dict(metrics=japi.MetricsSpec(crossval=True)), "exact-engine slice"),
    (dict(protocol="vc"), "vector-clock"),
    (dict(engine="exact"), "exact-engine slice"),
])
def test_from_dict_refuses_unported_sections(ref_kw, match):
    d = japi.RunSpec(**ref_kw).to_dict()
    with pytest.raises(tapi.SpecError, match=match):
        tapi.RunSpec.from_dict(d).validate()


def test_validation_errors():
    with pytest.raises(tapi.SpecError, match="device"):
        tapi.RunSpec(device="tpu").validate()
    with pytest.raises(tapi.SpecError, match="not a registered key"):
        tapi.RunSpec(topology=tapi.TopologySpec(kind="torus")).validate()
    with pytest.raises(tapi.SpecError, match="engine 'windowed'"):
        tapi.RunSpec(engine="vec",
                     window=tapi.WindowSpec(window=8)).validate()
    with pytest.raises(tapi.SpecError, match="unknown RunSpec field"):
        tapi.RunSpec.from_dict({"bogus": 1})
    with pytest.raises(tapi.SpecError, match="collect='full'"):
        tapi.run(tapi.RunSpec(
            device="cpu", engine="windowed",
            window=tapi.WindowSpec(window=16, collect="aggregate"),
            metrics=tapi.MetricsSpec(oracle=True)))
    for engine, shard in (("windowed", tapi.ShardSpec(devices=2)),
                          ("vec", tapi.ShardSpec(scan="off")),
                          ("windowed", tapi.ShardSpec(profile=True))):
        with pytest.raises(tapi.SpecError, match="engine 'sharded'"):
            tapi.RunSpec(engine=engine, shard=shard).validate()
    for shard in (tapi.ShardSpec(devices=0), tapi.ShardSpec(devices=True),
                  tapi.ShardSpec(scan="maybe")):
        with pytest.raises(tapi.SpecError, match="shard"):
            tapi.RunSpec(engine="sharded", shard=shard).validate()


def test_sharded_engine_auto_selection():
    """Rule 1 with ranks asked for, rule 3 with several ranks, and the
    CPU route counting one device; the budget window scales with the
    ranks as in the reference."""
    kw = dict(n=512, seed=3, memory_budget_mb=1,
              topology=tapi.TopologySpec(kind="kregular", k=6, max_delay=1),
              traffic=tapi.TrafficSpec(kind="poisson", rate=16.0,
                                       messages=400))
    for shard, window, want in (
            (tapi.ShardSpec(devices=2), tapi.WindowSpec(window=40),
             ("sharded", 40)),
            (tapi.ShardSpec(), tapi.WindowSpec(window=40),
             ("windowed", 40)),
            (tapi.ShardSpec(devices=4), tapi.WindowSpec(),
             ("sharded", 400)),
            (tapi.ShardSpec(devices=1), tapi.WindowSpec(),
             ("windowed", 256)),
            (tapi.ShardSpec(), tapi.WindowSpec(), ("windowed", 256))):
        spec = tapi.RunSpec(device="cpu", shard=shard, window=window, **kw)
        got = tapi.select_engine(spec, tapi.build_scenario(spec))
        assert got == want, (shard, window)
        ref = japi.RunSpec(backend="jax", shard=japi.ShardSpec(
            **dataclasses.asdict(shard)), window=japi.WindowSpec(
            **dataclasses.asdict(window)), **{
            key: (getattr(japi, type(v).__name__)(**dataclasses.asdict(v))
                  if dataclasses.is_dataclass(v) else v)
            for key, v in kw.items()})
        if shard.devices is not None:
            assert japi.select_engine(ref, japi.build_scenario(ref)) == want


def _sharded_pair(devices):
    kw = dict(n=96, seed=2,
              topology=tapi.TopologySpec(kind="kregular", k=5, max_delay=2),
              traffic=tapi.TrafficSpec(kind="poisson", rate=3.0,
                                       messages=60),
              window=tapi.WindowSpec(window=40, seg_len=4, collect="full"),
              metrics=tapi.MetricsSpec(oracle=True))
    ref, _ = _pair(engine="windowed", **dict(kw))
    port = tapi.RunSpec(device="cpu", engine="sharded",
                        shard=tapi.ShardSpec(devices=devices, profile=True),
                        **kw)
    return ref, port


@pytest.mark.parametrize("devices", [1, 2])
def test_sharded_run_matches_reference_windowed(devices):
    """``engine="sharded"`` through the front door — in process at one
    rank, on two spawned gloo ranks — equals the reference's windowed
    engine (the JAX sharded engine equals it by its own contract)."""
    ref_spec, port_spec = _sharded_pair(devices)
    want, got = japi.run(ref_spec), tapi.run(port_spec)
    assert (got.engine, got.window, got.device) == ("sharded", 40, "cpu")
    assert vars(got.stats) == vars(want.stats)
    assert got.delivered_frac == want.delivered_frac
    assert got.mean_latency == want.mean_latency
    assert got.oracle.ok and want.oracle.ok
    assert got.extras["devices"] == devices and got.extras["scan"] == "on"
    assert got.extras["profile_segments"] == got.result.segments > 0
    for key, v in want.extras.items():
        assert got.extras[key] == v, key
    json.dumps(got.to_dict())


def test_sharded_ranks_without_a_group_or_card_raise():
    from repro_torch.core.vecsim import static_scenario
    from repro_torch.core.vecsim.shard import execute_sharded, resolve_world
    scn = static_scenario(1, 16, k=4, m_app=4)
    with pytest.raises(RuntimeError, match="process group"):
        execute_sharded(scn, 8, n_devices=2, device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            resolve_world(2, torch.device("cuda"))
    assert resolve_world(None, torch.device("cpu")) == (0, 1)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run([sys.executable, "-m", "repro_torch.api", *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


def test_cli_runs_a_spec_and_reports_json():
    out = _cli("--device", "cpu", "--n", "64", "--dynamics", "churn",
               "--messages", "12", "--oracle")
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["device"] == "cpu" and rep["engine"] == "vec"
    assert rep["oracle_ok"] is True and rep["delivered_frac"] == 1.0
    # the default device is the card: without one the CLI says how to
    # run on the CPU instead of falling back to it
    out = _cli("--n", "64")
    if cuda_available()[0]:
        assert out.returncode == 0, out.stderr
    else:
        assert out.returncode == 2
        assert "device='cpu'" in out.stderr


def test_cli_runs_the_sharded_engine():
    out = _cli("--device", "cpu", "--engine", "sharded", "--devices", "1",
               "--scan", "off", "--profile", "--n", "64", "--topology",
               "kregular", "--k", "6", "--traffic", "poisson", "--rate",
               "2", "--messages", "30", "--window", "24", "--collect",
               "full", "--oracle")
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["engine"] == "sharded" and rep["oracle_ok"] is True
    assert rep["extras"]["scan"] == "off" and rep["extras"]["devices"] == 1
    assert rep["spec"]["shard"] == dict(devices=1, scan="off", profile=True)
