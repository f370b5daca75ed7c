"""The port's sharded engine (``repro_torch.core.vecsim.shard``) at one
rank, in process, on the CPU, against the JAX package's numpy windowed
engine — which the JAX sharded engine equals by its own contract (it
cannot run here: its int64 stats need ``enable_x64``).

* every builder of ``vecsim_cases`` at N in {64, 256}, ``scan`` on and
  off: delivered matrix, series, ``NetStats``, per-message aggregates,
  peak, latency sums and final state byte-identical, or both engines
  overflowing at the same round;
* horizon expiry, a window below ``M_total``, aggregate collection and
  the snapshot;
* the fast body runs on churn-free segments and the generic body on the
  gated ones (and every segment with ``scan="off"``);
* the latency histogram, the gauges and sampled provenance equal the
  reference's;
* the ring's collectives are the identity at one rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.vecsim import WindowOverflowError as RefOverflow
from repro.core.vecsim.stream import execute_windowed as ref_windowed
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.spans import EngineObs as JObs
from repro_torch.core.vecsim import WindowOverflowError, scenario_from_arrays
from repro_torch.core.vecsim.shard import (ShardGroup, ShardedStepper,
                                           execute_sharded)
from repro_torch.obs import EngineObs, FlightRecorder
from vecsim_cases import BUILDERS


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


def assert_same_run(got, want, full=True):
    """The sharded result ``got`` equals the windowed result ``want``."""
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


def _both(ref_scn, w, scan, **kw):
    """(port sharded result, reference windowed result), or (None, None)
    after checking that both overflow at the same round."""
    try:
        want = ref_windowed(ref_scn, w, backend="numpy", **kw)
    except RefOverflow as exc:
        with pytest.raises(WindowOverflowError) as got_exc:
            execute_sharded(port_scenario(ref_scn), w, device="cpu",
                            scan=scan, **kw)
        assert got_exc.value.round == exc.round
        return None, None
    return execute_sharded(port_scenario(ref_scn), w, device="cpu",
                           scan=scan, **kw), want


@pytest.mark.parametrize("scan", ["on", "off"])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("n", [64, 256])
def test_sharded_world1_byte_identical_to_numpy(builder, n, scan):
    """Full-width and half-width windows (the latter overflows on some
    builders: then both engines raise at the same round)."""
    ref_scn = BUILDERS[builder](5, n)
    for frac, seg in ((1.0, 16), (0.5, 8)):
        w = max(4, int(ref_scn.m_total * frac))
        got, want = _both(ref_scn, w, scan, collect="full", seg_len=seg)
        if got is not None:
            assert got.n_devices == 1 and got.scan == scan
            assert got.device == "cpu" and got.window == w
            assert_same_run(got, want)


@pytest.mark.parametrize("scan", ["on", "off"])
def test_horizon_small_window_aggregate_and_snapshot(scan):
    ref_scn = BUILDERS["churn"](13, 64)
    w = ref_scn.m_total
    got, want = _both(ref_scn, w, scan, horizon=6, seg_len=8,
                      collect="full")
    assert want.expired.any()
    assert_same_run(got, want)
    got, want = _both(ref_scn, w, scan, seg_len=8, collect="aggregate")
    assert_same_run(got, want, full=False)
    snap = int(ref_scn.add_round[-1])
    got, want = _both(ref_scn, w, scan, seg_len=8, collect="full",
                      snapshot_round=snap)
    assert_same_run(got, want)
    for key in want.snapshot:
        np.testing.assert_array_equal(got.snapshot[key], want.snapshot[key],
                                      err_msg=key)
    # a window below M_total that streams without overflowing
    ref_w = BUILDERS["waves"](5, 64)
    w = int(ref_w.m_total * 0.5)
    assert w < ref_w.m_total
    got, want = _both(ref_w, w, scan, seg_len=8, collect="full")
    assert got.peak_live <= w
    assert_same_run(got, want)


def test_overflow_round_parity_for_every_seg_len():
    ref_scn = BUILDERS["sustained_kreg"](2, 64)
    w = max(4, ref_scn.m_total // 4)
    for seg in (1, 4, 16):
        for scan in ("on", "off"):
            got, want = _both(ref_scn, w, scan, seg_len=seg)
            assert got is None and want is None, (seg, scan)


@pytest.mark.parametrize("builder,fast", [
    ("static", True), ("sustained_kreg", True), ("sustained_sw", True),
    ("crash", True), ("churn", False), ("link_add", False),
    ("waves", False), ("partition", False)])
def test_fast_body_on_quiescent_segments_generic_on_gated(builder, fast):
    """Churn-free runs take the bit-packed fast body on every segment
    with ``scan="on"``; runs that add links (live gating) never do; and
    ``scan="off"`` steps every segment through the generic body."""
    scn = port_scenario(BUILDERS[builder](5, 64))
    on = execute_sharded(scn, scn.m_total, device="cpu", seg_len=8,
                         collect="full")
    off = execute_sharded(scn, scn.m_total, device="cpu", seg_len=8,
                          collect="full", scan="off")
    assert on.scan == "on" and off.scan == "off"
    assert on.fast_segments + on.generic_segments == on.segments > 0
    if fast:
        assert on.fast_segments == on.segments and on.generic_segments == 0
    else:
        assert on.fast_segments == 0 and on.generic_segments == on.segments
    assert off.fast_segments == 0 and off.generic_segments == off.segments
    np.testing.assert_array_equal(on.delivered, off.delivered)
    np.testing.assert_array_equal(on.series, off.series)


def test_fast_body_between_churn_events():
    """A run whose link removals fall in some segments only (R-broadcast:
    no gating) mixes both bodies, and the inverse tables are rebuilt
    after each topology change, from the cache when it recurs."""
    ref = BUILDERS["churn"](7, 64)
    ref = dataclasses.replace(ref, mode="r", add_round=ref.add_round[:0],
                              add_p=ref.add_p[:0], add_k=ref.add_k[:0],
                              add_q=ref.add_q[:0],
                              add_delay=ref.add_delay[:0]).validate()
    got, want = _both(ref, ref.m_total, "on", seg_len=2, collect="full")
    assert_same_run(got, want)
    assert got.fast_segments > 0 and got.generic_segments > 0


@pytest.mark.parametrize("builder", ["churn", "sustained_kreg"])
def test_histogram_gauges_and_provenance_match_reference(builder):
    ref_scn = BUILDERS[builder](4, 96)
    w = ref_scn.m_total
    jobs = JObs(histograms=True, spans=True)
    jobs.flight = JFlight(rate=1, seed=0, sampler="all")
    want = ref_windowed(ref_scn, w, backend="numpy", seg_len=4,
                        collect="full", obs=jobs)
    tobs = EngineObs(histograms=True, spans=True)
    tobs.flight = FlightRecorder(rate=1, seed=0, sampler="all")
    got = execute_sharded(port_scenario(ref_scn), w, device="cpu",
                          seg_len=4, collect="full", obs=tobs, profile=True)
    assert_same_run(got, want)
    np.testing.assert_array_equal(tobs.latency_hist, jobs.latency_hist)
    assert tobs.latency_hist.sum() == got.lat_cnt > 0
    assert tobs.flight.export() == jobs.flight.export()
    assert tobs.flight.completed
    assert tobs.gauges == jobs.gauges
    assert {"stager_uploads", "stager_skips"} <= set(tobs.counters)
    names = {ev["name"] for ev in tobs.spans.events()}
    assert {"segment.stage", "segment.dispatch", "segment.block",
            "segment.retire", "stager.upload"} <= names
    assert len(got.seg_profile) == got.segments
    assert {"lo", "hi", "fast", "stage_s", "dispatch_s", "block_s",
            "retire_s"} <= set(got.seg_profile[0])


def test_stager_skips_unchanged_fields_and_prefetches():
    """Quiescent segments reuse the device buffers already staged: many
    more skips than uploads on a long churn-free run."""
    scn = port_scenario(BUILDERS["sustained_kreg"](1, 64))
    st = ShardedStepper(scn, scn.m_total, device="cpu", seg_len=2)
    while not st.done:
        st.advance()
    st.finish()
    assert st.stager.skips > st.stager.uploads > 0


def test_group_collectives_are_identity_at_one_rank():
    g = ShardGroup(rank=0, world=1, device=torch.device("cpu"), off=0)
    x = torch.arange(6, dtype=torch.int64).view(3, 2)
    assert g.ring_shift(x) is x
    assert g.all_reduce_sum(x) is x
    assert g.gather_rows(x) is x and g.gather_rows(x, everywhere=True) is x
