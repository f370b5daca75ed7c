"""The port's scenario module (``repro_torch.core.vecsim.scenario``) is
its own copy of the JAX package's builders: the same seed must give the
same arrays, and ``scenario_from_arrays`` must carry any scenario into
the port unchanged."""

import dataclasses

import numpy as np
import pytest

from repro.core.vecsim import scenario as jscn
from repro_torch.core.vecsim import scenario as tscn
from vecsim_cases import BUILDERS

# the port's twin of tests/vecsim_cases.BUILDERS, argument for argument
PORT_BUILDERS = {
    "static": lambda seed, n: tscn.static_scenario(seed, n),
    "link_add": lambda seed, n: tscn.link_add_scenario(seed, n),
    "churn": lambda seed, n: tscn.churn_scenario(seed, n),
    "crash": lambda seed, n: tscn.crash_scenario(seed, n),
    "waves": lambda seed, n: tscn.churn_wave_scenario(seed, n, waves=2),
    "partition": lambda seed, n: tscn.partition_heal_scenario(
        seed, max(n, 12), traffic_during_partition=bool(seed % 2)),
    "sustained_kreg": lambda seed, n: tscn.sustained_scenario(
        seed, n, k=5, rate=1.0 + (seed % 3), messages=24,
        topology="kregular", max_delay=2),
    "sustained_sw": lambda seed, n: tscn.sustained_scenario(
        seed, n, k=5, rate=2.0, messages=24, topology="smallworld",
        traffic="bursty", max_delay=2),
}

FIELDS = [f.name for f in dataclasses.fields(jscn.VecScenario)]


def _assert_same(a, b):
    for name in FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def test_port_builders_cover_every_case():
    assert set(PORT_BUILDERS) == set(BUILDERS)
    assert [f.name for f in dataclasses.fields(tscn.VecScenario)] == FIELDS


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("n", [64, 256])
def test_builders_identical_to_reference(builder, n):
    for seed in (3, 4):
        _assert_same(BUILDERS[builder](seed, n),
                     PORT_BUILDERS[builder](seed, n))


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_scenario_from_arrays_round_trips(builder):
    ref = BUILDERS[builder](5, 64)
    fields = {name: getattr(ref, name) for name in FIELDS}
    port = tscn.scenario_from_arrays(fields)
    assert isinstance(port, tscn.VecScenario)
    _assert_same(ref, port)
    again = tscn.scenario_from_arrays(
        {name: getattr(port, name) for name in FIELDS})
    _assert_same(port, again)
    assert port.m_total == ref.m_total
    np.testing.assert_array_equal(port.msg_counters(), ref.msg_counters())
    # the port owns its arrays: no view of the reference's
    assert not np.shares_memory(port.adj0, ref.adj0)


def test_scenario_from_arrays_validates():
    ref = BUILDERS["static"](1, 16)
    fields = {name: getattr(ref, name) for name in FIELDS}
    with pytest.raises(ValueError, match="unknown VecScenario field"):
        tscn.scenario_from_arrays({**fields, "bogus": 1})
    bad = dict(fields, bcast_round=fields["bcast_round"][::-1].copy())
    if len(bad["bcast_round"]) > 1 and bad["bcast_round"][0] != \
            bad["bcast_round"][-1]:
        with pytest.raises(ValueError, match="not sorted"):
            tscn.scenario_from_arrays(bad)
    with pytest.raises(ValueError, match="mode"):
        tscn.scenario_from_arrays(dict(fields, mode="vc"))


@pytest.mark.parametrize("kind", ["ring", "kregular", "smallworld"])
def test_topologies_and_bounds_identical(kind):
    a = jscn._TOPOLOGIES[kind](7, 40, 5, 3, 1, 0.3)
    b = tscn._TOPOLOGIES[kind](7, 40, 5, 3, 1, 0.3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert jscn.diameter_bound(a[0]) == tscn.diameter_bound(b[0])
    assert (jscn.settle_rounds(40, 5, 3, diam=4)
            == tscn.settle_rounds(40, 5, 3, diam=4))
    assert jscn.settle_rounds(5000, 8, 1) == tscn.settle_rounds(5000, 8, 1)


def test_traffic_models_identical():
    for a, b in ((jscn.poisson_traffic(2, 50, 3.5, 4, 40, 60),
                  tscn.poisson_traffic(2, 50, 3.5, 4, 40, 60)),
                 (jscn.bursty_traffic(2, 50, 6.0, 0.5, 16, 0.25, 0, 80),
                  tscn.bursty_traffic(2, 50, 6.0, 0.5, 16, 0.25, 0, 80))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert {"poisson", "bursty"} <= set(tscn._TRAFFIC)
