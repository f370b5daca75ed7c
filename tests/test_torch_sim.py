"""The port's monolithic engine (``repro_torch.core.vecsim.execute_vec``)
on the CPU against the JAX package's numpy engine — the byte-level
reference — on every scenario builder at N in {64, 256}: delivered
matrix, per-round series, NetStats, final state and a mid-run
snapshot (at the last churn round where the scenario churns)."""

import dataclasses

import numpy as np
import pytest

from repro.core.vecsim.sim import execute_vec as ref_execute_vec
from repro_torch.core.vecsim import execute_vec, scenario_from_arrays
from vecsim_cases import BUILDERS


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def _assert_states(a, b, what):
    assert sorted(a) == sorted(b), what
    for key in a:
        assert a[key].dtype == b[key].dtype, f"{what}/{key}"
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"{what}/{key}")


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("n", [64, 256])
def test_monolithic_byte_identical_to_numpy(builder, n):
    ref_scn = BUILDERS[builder](3, n)
    snap = (int(ref_scn.add_round[-1]) if ref_scn.n_adds
            else ref_scn.rounds // 2)
    want = ref_execute_vec(ref_scn, backend="numpy", snapshot_round=snap)
    got = execute_vec(port_scenario(ref_scn), device="cpu",
                      snapshot_round=snap)
    assert got.device == "cpu"
    np.testing.assert_array_equal(got.delivered, want.delivered)
    assert got.series.dtype == np.int64
    np.testing.assert_array_equal(got.series, want.series)
    assert vars(got.stats) == vars(want.stats)
    _assert_states(got.state, want.state, "state")
    _assert_states(got.snapshot, want.snapshot, "snapshot")
    assert got.delivered_frac() == want.delivered_frac()
    assert got.mean_latency() == pytest.approx(want.mean_latency(),
                                               nan_ok=True, rel=0, abs=0)


@pytest.mark.parametrize("mode,always_gate", [("r", False), ("pc", True)])
def test_protocol_variants_byte_identical(mode, always_gate):
    """R-broadcast (no gating) and the paper-faithful unconditional
    gating take the same paths as the reference."""
    ref_scn = dataclasses.replace(BUILDERS["churn"](11, 64), mode=mode,
                                  always_gate=always_gate).validate()
    want = ref_execute_vec(ref_scn, backend="numpy")
    got = execute_vec(port_scenario(ref_scn), device="cpu")
    np.testing.assert_array_equal(got.delivered, want.delivered)
    np.testing.assert_array_equal(got.series, want.series)
    assert vars(got.stats) == vars(want.stats)
    _assert_states(got.state, want.state, "state")
