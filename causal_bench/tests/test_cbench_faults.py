"""A run of each cell with its timed path broken underneath comes out
not correct: the harness's whole run (set-up, window, reference,
metrics, result line) on the CPU at a small size, with the program's
delivery sweep patched to fail in one way each.  (The cells run on one
chip, so no exchange between chips can be left out.)"""

from __future__ import annotations

import io
import json
import time

import pytest
import torch

from causal_bench.harness import main
from causal_bench.harness.main import measure
from causal_bench.tests.small import small_spec


@pytest.fixture(autouse=True)
def _no_jax_guard(monkeypatch):
    """These runs share a test process with the suite's tests of the JAX
    package, so the harness's JAX guard (tested on its own in
    ``test_cbench_imports.py``) would end them: it is held off here."""
    monkeypatch.setattr(main, "banned_modules", lambda: [])


def _unchanged(orig):
    """A step that returns its state unchanged."""
    def sweep(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t):
        n = arr.shape[0]
        z = torch.zeros(n, dtype=torch.int32)
        return arr, delivered, z, z
    return sweep


def _half(orig):
    """Half of the message columns (every other one) left out of each
    sweep."""
    def sweep(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t):
        keep_a, keep_d = arr[:, 1::2].clone(), delivered[:, 1::2].clone()
        out = orig(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t)
        arr[:, 1::2] = keep_a
        delivered[:, 1::2] = keep_d
        return out
    return sweep


def _altered(orig):
    """One delivery round altered where it is produced: every 50th round
    from round 50 on, its first delivery reads a round later."""
    def sweep(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t):
        out = orig(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t)
        if t >= 50 and t % 50 == 0:
            hit = torch.nonzero(delivered == t)
            if len(hit):
                delivered[hit[0, 0], hit[0, 1]] = t + 1
        return out
    return sweep


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", ["kreg10k.poisson", "kreg64k.bursty"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.vecsim import kernels as kx
    monkeypatch.setattr(kx, "fused_sweep", fault(kx.fused_sweep))
    out, err = io.StringIO(), io.StringIO()
    rc = measure(small_spec(cell), 21, 0.0, False, "cpu",
                 time.perf_counter(), out=out, err=err)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is False
    assert list(line)[-1] == "checks"
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", ["kreg10k.poisson", "kreg64k.bursty"])
def test_sound_run_is_correct(cell):
    out, err = io.StringIO(), io.StringIO()
    rc = measure(small_spec(cell), 21, 0.0, False, "cpu",
                 time.perf_counter(), out=out, err=err)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) >= {"setup_s"}
    assert line["failed"] == 0 and line["attempted"] > 0


def test_traced_run_reads_the_tick_tail_from_an_untraced_window():
    """A ``--trace 1`` run of the live cell first makes a window with
    tracing off, for ``tick_ms_p95``, and judges its repetitions too."""
    out, err = io.StringIO(), io.StringIO()
    rc = measure(small_spec("kreg64k.bursty"), 22, 0.0, True, "cpu",
                 time.perf_counter(), out=out, err=err)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["tick_ms_p95"]["value"] > 0
    assert line["attempted"] == 2 * 1500
    assert "time untraced reps" in err.getvalue()
