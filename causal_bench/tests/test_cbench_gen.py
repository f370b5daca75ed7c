"""The benchmark's frozen generators: deterministic by seed, valid as
the program's scenarios, and equal to the program's own builders that
they were copied from."""

from __future__ import annotations

import json

import numpy as np
import pytest

from causal_bench.gen.traffic import build_inputs
from causal_bench.harness.spec import BENCH_DIR, load_file
from causal_bench.tests.small import small_spec

BIG_SEED = 2 ** 31 + 12345
kregular_topology = load_file("gen/overlays", "kregular").kregular_topology


@pytest.mark.parametrize("cell", ["kreg10k.poisson", "kreg64k.bursty"])
def test_inputs_are_deterministic_by_seed(cell):
    spec = small_spec(cell)
    a = build_inputs(spec.config, spec.traffic, BIG_SEED)
    b = build_inputs(spec.config, spec.traffic, BIG_SEED)
    c = build_inputs(spec.config, spec.traffic, BIG_SEED + 1)
    for key, val in a.items():
        assert np.array_equal(val, b[key]), key
    assert not np.array_equal(a["adj0"], c["adj0"])


@pytest.mark.parametrize("cell", ["kreg10k.poisson", "kreg64k.bursty"])
def test_inputs_validate_as_scenarios(cell):
    from repro_torch.core.vecsim.scenario import VecScenario
    spec = small_spec(cell)
    inp = build_inputs(spec.config, spec.traffic, 7)
    VecScenario(n=inp["n"], k=inp["k"], rounds=inp["rounds"],
                adj0=inp["adj0"], delay0=inp["delay0"],
                bcast_round=inp["bcast_round"],
                bcast_origin=inp["bcast_origin"]).validate()
    if "arr_round" in inp:
        assert len(inp["arr_round"]) == spec.traffic["messages"]
        assert (np.diff(inp["arr_round"]) >= 0).all()
    else:
        assert len(inp["bcast_round"]) == spec.traffic["messages"]


@pytest.mark.parametrize("free_slots", [0, 1])
def test_overlay_equals_the_program_builder(free_slots):
    from repro_torch.core.vecsim import scenario as prog
    for seed in (0, BIG_SEED):
        mine = kregular_topology(seed, 97, 8, 2, free_slots)
        theirs = prog.kregular_topology(seed, 97, 8, 2, free_slots)
        assert all(np.array_equal(x, y) for x, y in zip(mine, theirs))


def test_schedule_equals_sustained_scenario():
    from repro_torch.core.vecsim.scenario import sustained_scenario
    spec = small_spec("kreg10k.poisson")
    cfg, mix = spec.config, spec.traffic
    inp = build_inputs(cfg, mix, BIG_SEED)
    scn = sustained_scenario(BIG_SEED, cfg["n"], k=cfg["k"],
                             rate=mix["rate"], messages=mix["messages"],
                             topology="kregular", traffic="poisson",
                             max_delay=cfg["max_delay"])
    for key in ("adj0", "delay0", "bcast_round", "bcast_origin"):
        assert np.array_equal(inp[key], getattr(scn, key)), key
    assert inp["rounds"] == scn.rounds


def test_submissions_equal_the_live_arrivals():
    from repro_torch.core.vecsim.live.arrivals import build_arrivals
    from repro_torch.core.vecsim.scenario import static_scenario
    spec = small_spec("kreg64k.bursty")
    cfg, mix = spec.config, spec.traffic
    inp = build_inputs(cfg, mix, BIG_SEED)
    r, o = build_arrivals("bursty", BIG_SEED + 1, cfg["n"], mix["rate"],
                          mix["messages"], rate_lo=mix["rate_lo"],
                          period=mix["period"], duty=mix["duty"])
    assert np.array_equal(inp["arr_round"], r)
    assert np.array_equal(inp["arr_origin"], o)
    base = static_scenario(BIG_SEED, cfg["n"], k=cfg["k"], m_app=8,
                           max_delay=cfg["max_delay"], topology="kregular")
    assert np.array_equal(inp["adj0"], base.adj0)
    assert np.array_equal(inp["delay0"], base.delay0)
    assert inp["rounds"] == base.rounds


@pytest.mark.parametrize("kind,key", [("traffic", "arrivals"),
                                      ("configs", "overlay")])
def test_every_mix_and_configuration_finds_its_generator(kind, key):
    """A mix's arrival process and a configuration's overlay are files
    of their own, found by name; an unknown name is refused."""
    folder = {"arrivals": "gen/arrivals", "overlay": "gen/overlays"}[key]
    attr = {"arrivals": "inputs", "overlay": "build"}[key]
    for path in sorted((BENCH_DIR / kind).glob("*.json")):
        name = json.loads(path.read_text())[key]
        assert callable(getattr(load_file(folder, name), attr)), path
    with pytest.raises(FileNotFoundError):
        load_file(folder, "no.such.kind")
