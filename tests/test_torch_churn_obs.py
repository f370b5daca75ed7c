"""The windowed engine's ``segment.blocked`` counter and the
``retire.gates`` span, on the CPU.

* on churn scenarios, each segment's ``segment.blocked`` equals the
  live app columns that every process has delivered and that a process
  delivered at or after one of its open gates, worked out again from
  the engine's state after the segment;
* ``retire.gates`` opens inside ``segment.retire``, once a retirement
  sweep, and holds no span: the decision reads nothing more from the
  card, and the hung gates are cleared there;
* with telemetry off (``NULL_RECORDER``) nothing is recorded and the
  results are byte-equal to a traced run's;
* a run without link changes counts no blocked column.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.core.vecsim.scenario import (churn_wave_scenario,
                                              link_add_scenario,
                                              sustained_scenario)
from repro_torch.core.vecsim.stream import WindowedStepper
from repro_torch.obs.spans import NULL_RECORDER, EngineObs, SpanRecorder

COUNTERS = ("segment.blocked",)


class _Edges(SpanRecorder):
    """A recorder that also keeps each (parent, child) of an opened
    span."""

    def __init__(self):
        super().__init__(1 << 16)
        self.edges = []

    def begin(self, name_id):
        d = self.depth
        parent = self._names[self._stack_name[d - 1]] if d else None
        self.edges.append((parent, self._names[name_id]))
        super().begin(name_id)


def _held(st, cw):
    """Live app columns that every live process has delivered and that
    some process delivered at or after one of its open gates."""
    d = st["delivered"].numpy()
    gate, active = st["gate"].numpy(), st["active"].numpy()
    alive = ~st["crashed"].numpy()
    open_ = (gate >= 0) & active & alive[:, None]
    min_gate = np.where(open_, gate, np.iinfo(np.int32).max).min(axis=1)
    live_app = (cw.slot_msg >= 0) & cw.slot_app
    full = ((d >= 0) | ~alive[:, None]).all(axis=0)
    met = ((d >= 0) & (d >= min_gate[:, None])).any(axis=0)
    return int((live_app & full & met).sum())


def _stepped(scn, window, seg_len, horizon=None):
    """Step ``scn`` with a recording engine; per segment its rounds,
    the counters' values and the same numbers worked out again."""
    rec = _Edges()
    obs = EngineObs(histograms=True, spans=False)
    obs.spans = rec
    stp = WindowedStepper(scn, window, device="cpu", seg_len=seg_len,
                          horizon=horizon, collect="aggregate", obs=obs)
    segs = []
    while not stp.done:
        n0 = rec.n
        t0 = stp.t
        t1 = stp.advance()
        got = {}
        for e in rec.events()[n0:]:
            if e["kind"] == "counter" and e["name"] in COUNTERS:
                got[e["name"]] = e["value"]
        want = {"segment.blocked": _held(stp.st, stp.cw),
                "gated": int((stp.st["gate"] >= 0).sum())}
        segs.append((t0, t1, got, want))
    return stp, rec, segs


SCENARIOS = {
    "churn_wave": lambda: churn_wave_scenario(
        5, 96, k=6, m_app=60, waves=3, adds_per_wave=10, rms_per_wave=8,
        max_delay=2, topology="kregular"),
    "link_add": lambda: link_add_scenario(3, 80, k=5, m_app=40, n_adds=12,
                                          max_delay=2),
}


@pytest.mark.parametrize("seg_len", [3, 8])
@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_counters_equal_the_schedule_and_the_state(kind, seg_len):
    scn = SCENARIOS[kind]()
    stp, _, segs = _stepped(scn, 256, seg_len)
    for t0, t1, got, want in segs:
        assert got == {"segment.blocked": float(want["segment.blocked"])}, \
            (t0, t1)
        assert want["gated"] == stp.series[t1 - 1, 5]
    assert scn.n_adds > 0
    assert max(w["gated"] for _, _, _, w in segs) > 0
    assert max(g["segment.blocked"] for _, _, g, _ in segs) > 0


def test_retire_gates_nests_in_segment_retire():
    scn = SCENARIOS["churn_wave"]()
    stp, rec, _ = _stepped(scn, 256, 4, horizon=6)
    inside = [p for p, c in rec.edges if c == "retire.gates"]
    assert inside and set(inside) == {"segment.retire"}
    assert len(inside) == stp.retirer.sweeps
    assert not {c for p, c in rec.edges if p == "retire.gates"}
    assert rec.depth == 0 and rec.dropped == 0


def _result(scn, obs):
    stp = WindowedStepper(scn, 256, device="cpu", seg_len=4,
                          collect="full", obs=obs)
    while not stp.done:
        stp.advance()
    res = stp.finish()
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
            if f.name not in ("scenario", "stats", "state")}, res.stats


def test_null_recorder_records_nothing():
    scn = SCENARIOS["churn_wave"]()
    n_before = NULL_RECORDER.n
    quiet = _result(scn, EngineObs(histograms=True, spans=False))
    assert NULL_RECORDER.n == n_before == 0
    assert NULL_RECORDER.events() == []
    untraced = _result(scn, None)
    traced = _result(scn, EngineObs(histograms=True, spans=True))
    for other in (untraced, traced):
        assert other[1] == quiet[1]
        for key, val in quiet[0].items():
            assert np.array_equal(np.asarray(other[0][key]),
                                  np.asarray(val)), key


def test_a_run_without_churn_counts_nothing():
    scn = sustained_scenario(2, 64, k=4, rate=3.0, messages=150)
    assert scn.n_adds == 0 and len(scn.rm_round) == 0
    _, rec, segs = _stepped(scn, 128, 8)
    assert segs
    for _, _, got, _ in segs:
        assert got == {name: 0.0 for name in COUNTERS}
