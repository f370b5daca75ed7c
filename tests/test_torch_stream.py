"""The port's streaming windowed engine
(``repro_torch.core.vecsim.execute_windowed``) on the CPU against the
JAX package's numpy windowed engine: delivered matrix, series, stats,
per-message aggregates, peak, latency sums and final state on every
builder; aggregate collection, horizon expiry, seg_len invariance and
overflow-round parity; and one windowed result against the exact event
engine through the reference's cross-validation."""

import dataclasses

import numpy as np
import pytest

from repro.core.vecsim import WindowOverflowError as RefOverflow
from repro.core.vecsim.crossval import cross_validate
from repro.core.vecsim.stream import execute_windowed as ref_windowed
from repro_torch.core.vecsim import (WindowedStepper, WindowOverflowError,
                                     execute_windowed, scenario_from_arrays)
from vecsim_cases import BUILDERS


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def _assert_windowed(got, want, full=True):
    if full:
        np.testing.assert_array_equal(got.delivered, want.delivered)
    else:
        assert got.delivered is None and want.delivered is None
    np.testing.assert_array_equal(got.series, want.series)
    assert vars(got.stats) == vars(want.stats)
    for name in ("deliv_count", "deliv_round_sum", "bcast_done", "expired"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.peak_live == want.peak_live
    assert (got.lat_sum, got.lat_cnt) == (want.lat_sum, want.lat_cnt)
    assert got.delivered_frac() == want.delivered_frac()
    for key in want.state:
        np.testing.assert_array_equal(got.state[key], want.state[key],
                                      err_msg=key)


def _both(ref_scn, w, **kw):
    """(port result, reference result), or the two overflow errors."""
    try:
        want = ref_windowed(ref_scn, w, backend="numpy", **kw)
    except RefOverflow as exc:
        with pytest.raises(WindowOverflowError) as got_exc:
            execute_windowed(port_scenario(ref_scn), w, device="cpu", **kw)
        assert got_exc.value.round == exc.round
        return None, None
    return execute_windowed(port_scenario(ref_scn), w, device="cpu",
                            **kw), want


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("n", [64, 256])
def test_windowed_byte_identical_to_numpy(builder, n):
    """Full-width and half-width windows (the latter overflows on some
    builders: then both engines raise at the same round)."""
    ref_scn = BUILDERS[builder](5, n)
    for frac, seg in ((1.0, 16), (0.5, 8)):
        w = max(4, int(ref_scn.m_total * frac))
        got, want = _both(ref_scn, w, collect="full", seg_len=seg)
        if got is not None:
            assert got.device == "cpu" and got.window == w
            _assert_windowed(got, want)


def test_windowed_aggregate_horizon_and_snapshot():
    ref_scn = BUILDERS["churn"](13, 64)
    w = ref_scn.m_total
    got, want = _both(ref_scn, w, horizon=24, seg_len=8, collect="full")
    _assert_windowed(got, want)
    got, want = _both(ref_scn, w, seg_len=8, collect="aggregate")
    _assert_windowed(got, want, full=False)
    snap = int(ref_scn.add_round[-1])
    got, want = _both(ref_scn, w, seg_len=8, collect="full",
                      snapshot_round=snap)
    for key in want.snapshot:
        np.testing.assert_array_equal(got.snapshot[key], want.snapshot[key],
                                      err_msg=key)


def test_horizon_expiry_matches_reference():
    """A tight horizon force-expires columns (and clears hung gates) in
    exactly the reference's rounds."""
    ref_scn = BUILDERS["link_add"](2, 64)
    got, want = _both(ref_scn, ref_scn.m_total, horizon=4, seg_len=8,
                      collect="full")
    assert want.expired.any()
    _assert_windowed(got, want)


def test_seg_len_invariance():
    ref_scn = BUILDERS["waves"](4, 64)
    scn = port_scenario(ref_scn)
    runs = [execute_windowed(scn, scn.m_total, device="cpu", seg_len=s,
                             collect="full") for s in (3, 8, 32)]
    for other in runs[1:]:
        np.testing.assert_array_equal(runs[0].delivered, other.delivered)
        np.testing.assert_array_equal(runs[0].series, other.series)
        assert runs[0].stats == other.stats
        assert (runs[0].lat_sum, runs[0].lat_cnt) == (other.lat_sum,
                                                      other.lat_cnt)


def test_overflow_round_parity_and_state_clean():
    ref_scn = BUILDERS["sustained_kreg"](5, 256)
    w = 6
    with pytest.raises(RefOverflow) as ref_exc:
        ref_windowed(ref_scn, w, backend="numpy", seg_len=4)
    for seg in (1, 4, 16):
        with pytest.raises(WindowOverflowError) as exc:
            execute_windowed(port_scenario(ref_scn), w, device="cpu",
                             seg_len=seg)
        assert exc.value.round == ref_exc.value.round
    # the raise leaves the window exactly as the segment boundary had it
    stepper = WindowedStepper(port_scenario(ref_scn), w, device="cpu",
                              seg_len=4)
    while True:
        cw = stepper.cw
        before = (stepper.t, cw.next_bc, cw.next_add, cw.slot_msg.copy(),
                  cw.slot_birth.copy(), cw.slot_app.copy())
        try:
            stepper.advance()
        except WindowOverflowError:
            break
    after = (stepper.t, cw.next_bc, cw.next_add, cw.slot_msg, cw.slot_birth,
             cw.slot_app)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


def test_windowed_result_cross_validates_against_exact_engine():
    """The reference's exact event engine replays the scenario; the
    port's windowed delivered matrix gives the same delivery multiset
    and a clean oracle."""
    ref_scn = BUILDERS["churn"](6, 64)
    got = execute_windowed(port_scenario(ref_scn), ref_scn.m_total,
                           device="cpu", seg_len=8, collect="full")
    out = cross_validate(ref_scn, seed=6, vec_result=got)
    assert out["vec"] is got
    assert out["vec_multiset"] == out["exact_multiset"]
    assert out["vec_report"].ok and out["exact_report"].ok
