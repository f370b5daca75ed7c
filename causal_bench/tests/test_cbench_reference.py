"""The plain reference agrees with the port's own run of each cell at a
small size on the CPU, number for number, and the configuration's
control path, which breaks a stated guarantee, is judged not correct."""

from __future__ import annotations

import pytest

from causal_bench.harness.spec import load_driver
from causal_bench.tests.small import small_spec

CELLS = ["kreg10k.poisson", "kreg64k.bursty"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell, seed):
    spec = small_spec(cell)
    run = load_driver(spec).Cell(spec, seed, "cpu")
    verdict = run.judge([run.rep()], "cpu")
    assert verdict.correct, verdict.checks
    assert all(v == 0 for v, _ in verdict.checks.values())
    assert verdict.attempted == spec.traffic["messages"]
    assert verdict.failed == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = small_spec(cell)
    run = load_driver(spec).Cell(spec, 11, "cpu")
    verdict = run.judge([run.rep(control=True)], "cpu")
    assert not verdict.correct
    assert verdict.checks["answers_wrong"][0] > 0 or \
        verdict.checks.get("admission_wrong", (0,))[0] > 0
    assert verdict.failed > 0


def test_live_reference_sees_backpressure():
    """The small serving cell fills its window: the reference's queue,
    deferral and retirement are exercised, not bypassed."""
    spec = small_spec("kreg64k.bursty")
    run = load_driver(spec).Cell(spec, 5, "cpu")
    out = run.rep().out
    assert out["backpressure_ticks"] > 0
    assert out["peak_live"] == spec.config["window"]
