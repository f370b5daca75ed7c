"""The port's telemetry (``repro_torch.obs``, the ``latency_hist`` and
``retire_scan`` kernels' plain versions, and the ``obs`` section of the
front door) on the CPU against the JAX package.

* the bucket rules: ``bucket_index_torch`` and the kernel's
  ``31 - __clz`` rule equal ``bucket_index_np`` on every value 0..2^21
  and at the int32 extremes;
* ``latency_hist`` refuses column indices outside the plane;
* ``latency_hist`` and ``retire_scan`` equal the JAX package's Pallas
  ops in interpret mode (and ``hist_np``) byte for byte, tolerance 0;
* a windowed spec with ``obs`` at its defaults reports the same extras,
  key for key, as the JAX package's numpy windowed run — the latency
  percentiles and ``latency_hist_total`` included;
* histograms, metrics docs (wall-clock fields aside) and provenance
  exports are byte-identical to the JAX package's, with both samplers,
  at N in {64, 256} under churn;
* a corrupted sampled delivery vector trips the causality auditor;
* the Chrome trace loads back as JSON, with the documented span tree a
  segment and its times on the unix clock;
* on a batch and a live run, every span opens inside its documented
  parent, every blocking copy inside an engine phase, none is left
  open, and the results are byte-equal with spans on and off;
* the windowed engine's set-up uploads no (N, W) plane, and its finish
  reads none back: its ``copy.d2h`` spans are the eight tables, the
  planes' check and the drain's own reads.
"""

import dataclasses
import functools
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core.vecsim import kernels as jkx
from repro.obs import hist as jhist
from repro.obs.sinks import load_metrics_jsonl as j_load_metrics
from repro_torch import api as tapi
from repro_torch.core.vecsim import kernels as tkx
from repro_torch.core.vecsim.live.loop import LiveLoop
from repro_torch.core.vecsim.scenario import churn_scenario, static_scenario
from repro_torch.core.vecsim.stream import WindowedStepper, execute_windowed
from repro_torch.obs import (NB, CausalityViolationError, EngineObs,
                             FlightRecorder, CausalAuditor, SpanRecorder,
                             bucket_index_torch, hist_np,
                             load_metrics_jsonl, percentiles_from_hist,
                             write_chrome_trace)

INT32_MAX = 2 ** 31 - 1


def _values():
    """Every value in [-3, 2^21] and the int32 extremes."""
    return np.concatenate([np.arange(-3, 2 ** 21 + 1),
                           [2 ** 25, 2 ** 30 - 1, 2 ** 30, INT32_MAX]])


def test_bucket_index_torch_matches_numpy_on_every_value():
    v = _values()
    want = jhist.bucket_index_np(v)
    got = bucket_index_torch(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


def _clz32(x):
    """``__clz`` of a positive int32: leading zero bits, by a binary
    search over the top 16, 8, 4, 2 and 1 bits."""
    x = np.asarray(x, np.int64).astype(np.uint32)
    n = np.zeros(x.shape, np.int64)
    for s in (16, 8, 4, 2, 1):
        top_zero = x < np.uint32(1 << (32 - s))
        n += np.where(top_zero, s, 0)
        x = np.where(top_zero, x << np.uint32(s), x)
    return n


def test_kernel_log2_bucket_rule_equals_the_comparisons():
    """The CUDA kernel buckets ``lat >= 16`` as ``min(16 + (31 -
    __clz(lat)) - 4, 31)``; that arithmetic, written out here, equals
    the 15 comparisons of the contract on every value, boundaries
    included.  (The plain version buckets with the comparisons, so the
    card check holds the kernel against an independent rule.)"""
    v = _values()
    lg = 31 - _clz32(np.maximum(v, 1))
    got = np.where(v < 16, np.clip(v, 0, 15),
                   np.minimum(16 + lg - 4, NB - 1))
    np.testing.assert_array_equal(got, jhist.bucket_index_np(v))
    pw = np.array([1 << k for k in range(31)], np.int64)
    np.testing.assert_array_equal(31 - _clz32(pw), np.arange(31))
    np.testing.assert_array_equal(31 - _clz32(pw[1:] - 1), np.arange(30))


def _hist_inputs(rng, n, w):
    """Latencies that reach every one of the 32 buckets (one bucket's
    lower bound, its last value, or a value inside it), rows that never
    delivered and columns with no latency base."""
    lo = jhist.bucket_lower_bounds()
    hi = np.append(lo[1:] - 1, 2 ** 29)
    pick = rng.integers(0, NB, (n, w))
    where = rng.integers(0, 3, (n, w))
    lat = np.where(where == 0, lo[pick],
                   np.where(where == 1, hi[pick],
                            (lo[pick] + hi[pick]) // 2))
    base = rng.integers(0, 50, w).astype(np.int64)
    base[rng.random(w) < 0.2] = -1
    delivered = np.where(base[None, :] >= 0, base[None, :] + lat,
                         lat).astype(np.int32)
    delivered[rng.random((n, w)) < 0.25] = -1
    return base.astype(np.int32), delivered


@pytest.mark.parametrize("w", [1, 5, 37])
def test_latency_hist_matches_pallas_op_and_hist_np(w):
    rng = np.random.default_rng(100 + w)
    base, delivered = _hist_inputs(rng, 200, w)
    got = tkx.latency_hist(torch.from_numpy(base),
                           torch.from_numpy(delivered)).numpy()
    want = np.asarray(jkx.latency_hist(base, delivered, interpret=True))
    assert got.dtype == np.int32 and got.shape == (w, NB)
    np.testing.assert_array_equal(got, want)
    for j in range(w):
        d = delivered[:, j].astype(np.int64)
        ok = (d >= 0) & (base[j] >= 0)
        np.testing.assert_array_equal(got[j], hist_np(d[ok] - base[j]))
    if w > 1:
        # every bucket is reached, so the test covers the whole rule
        assert (got.sum(axis=0) > 0).all()
    # the column-index argument reads the same columns in place
    cols = rng.permutation(w)[: max(1, w // 2)]
    sel = tkx.latency_hist(torch.from_numpy(base[cols]),
                           torch.from_numpy(delivered),
                           torch.from_numpy(cols.astype(np.int64))).numpy()
    np.testing.assert_array_equal(sel, got[cols])


@pytest.mark.parametrize("bad", [-1, 7])
def test_latency_hist_refuses_columns_outside_the_plane(bad):
    """The wrapper checks the host's column indices against ``[0, W)``
    before it routes, so the card and the CPU refuse them alike."""
    rng = np.random.default_rng(3)
    base, delivered = _hist_inputs(rng, 16, 7)
    cols = torch.tensor([0, bad, 2], dtype=torch.int64)
    with pytest.raises(IndexError, match="7 columns"):
        tkx.latency_hist(torch.from_numpy(base[:3]),
                         torch.from_numpy(delivered), cols)


def test_retire_scan_matches_pallas_op():
    rng = np.random.default_rng(7)
    for n, w in ((16, 9), (24, 7), (8, 1), (12, 11)):
        delivered = np.where(rng.random((n, w)) < 0.4,
                             rng.integers(0, 20, (n, w)), -1).astype(np.int32)
        crashed = rng.random(n) < 0.2
        min_gate = np.where(rng.random(n) < 0.3, rng.integers(0, 15, n),
                            2 ** 30).astype(np.int32)
        got = tkx.retire_scan(torch.from_numpy(delivered),
                              torch.from_numpy(crashed),
                              torch.from_numpy(min_gate))
        want = jkx.retire_scan(delivered, crashed, min_gate, interpret=True)
        for g, x in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        # the first three outputs of retire_reduce
        arr = np.full((n, w), 2 ** 30, np.int32)
        full = tkx.retire_reduce(torch.from_numpy(arr),
                                 torch.from_numpy(delivered),
                                 torch.from_numpy(crashed),
                                 torch.from_numpy(min_gate), 20)
        for g, x in zip(got, full[:3]):
            assert torch.equal(g, x)


# --------------------------------------------------------------------- #
# The front door: extras, metrics doc, provenance against the reference
# --------------------------------------------------------------------- #
def _specs(**kw):
    """(JAX spec on the numpy backend, port spec on the CPU) for the same
    experiment; sections are given as dicts."""
    d = dict(kw)
    return (japi.RunSpec.from_dict(dict(d, backend="numpy")),
            tapi.RunSpec.from_dict(dict(d, device="cpu")))


_WALL = ("wall_seconds", "serve_requests_per_sec")

EXTRAS_CASES = {
    "poisson_n128": dict(
        n=128, seed=0, engine="windowed",
        topology=dict(kind="kregular", k=4, max_delay=2),
        traffic=dict(kind="poisson", rate=4.0, messages=200),
        window=dict(window=64, seg_len=8)),
    "churn_horizon": dict(
        n=64, seed=3, dynamics=dict(kind="churn"),
        traffic=dict(messages=24), window=dict(window=40, seg_len=4,
                                               horizon=30)),
    "vec_engine": dict(n=64, seed=1, dynamics=dict(kind="link_add")),
}


@pytest.mark.parametrize("case", sorted(EXTRAS_CASES))
def test_windowed_extras_match_reference_with_obs_defaults(case):
    """The repair of the port's windowed report: with ``obs`` at its
    defaults the histogram is on for windowed runs (off for the
    monolithic engine), as in the JAX package."""
    jspec, tspec = _specs(**EXTRAS_CASES[case])
    want, got = japi.run(jspec), tapi.run(tspec)
    assert got.engine == want.engine
    assert got.extras == want.extras
    if want.engine == "windowed":
        assert {"latency_p50", "latency_p99", "latency_p999",
                "latency_hist_total"} <= set(got.extras)
        np.testing.assert_array_equal(got.obs.latency_hist,
                                      want.obs.latency_hist)
    else:
        assert got.obs is None and want.obs is None


def _doc_without_wall(doc):
    doc = dict(doc)
    doc["summary"] = {k: v for k, v in doc["summary"].items()
                      if k not in _WALL}
    run = dict(doc["run"])
    # the one renamed field, as in RunSpec: backend -> device
    run.pop("backend", None)
    run.pop("device", None)
    doc["run"] = run
    doc["latency_hist"] = (None if doc["latency_hist"] is None
                           else doc["latency_hist"].tolist())
    return doc


@pytest.mark.parametrize("sampler,rate", [("all", 1), ("hash", 3)])
@pytest.mark.parametrize("n", [64, 256])
def test_hist_metrics_and_provenance_identical_to_reference(
        tmp_path, sampler, rate, n):
    cfg = dict(n=n, seed=5, dynamics=dict(kind="churn"),
               traffic=dict(messages=20),
               window=dict(window=n // 8 + 16, seg_len=4, collect="full"),
               metrics=dict(oracle=True))
    out = {}
    for side in ("jax", "port"):
        obs = dict(provenance=rate, sampler=sampler, audit="fail",
                   metrics_out=str(tmp_path / f"{side}.jsonl"),
                   trace_out=str(tmp_path / f"{side}.trace.json"))
        jspec, tspec = _specs(**cfg, obs=obs)
        out[side] = (japi.run(jspec) if side == "jax" else tapi.run(tspec))
    want, got = out["jax"], out["port"]
    assert got.oracle.ok and want.oracle.ok
    np.testing.assert_array_equal(got.obs.latency_hist,
                                  want.obs.latency_hist)
    assert got.obs.latency_hist.sum() == got.extras["latency_hist_total"]
    assert got.obs.flight.export() == want.obs.flight.export()
    assert got.extras["provenance_sampled"] > 0
    assert got.extras["audit_pairs_checked"] == \
        want.extras["audit_pairs_checked"]
    assert got.obs.gauges == want.obs.gauges
    jdoc = j_load_metrics(str(tmp_path / "jax.jsonl"))
    tdoc = load_metrics_jsonl(str(tmp_path / "port.jsonl"))
    assert tdoc["run"]["device"] == "cpu" and jdoc["run"]["backend"] == "numpy"
    assert _doc_without_wall(tdoc) == _doc_without_wall(jdoc)
    # the two packages read each other's files
    assert _doc_without_wall(j_load_metrics(str(tmp_path / "port.jsonl"))) \
        == _doc_without_wall(tdoc)


_SEGMENT_SPANS = ("segment.activate", "segment.dispatch", "segment.upload",
                  "segment.enqueue", "segment.wait", "segment.retire")
_SWEEP_SPANS = ("retire.reduce", "retire.gates", "retire.fold")


def _assert_unix_clock(spans, before, after):
    """Every span's Chrome-trace interval (microseconds) lies between
    two ``time.time_ns()`` reads taken around the run."""
    first = min(e["ts"] for e in spans)
    last = max(e["ts"] + e["dur"] for e in spans)
    assert before <= first * 1000 <= last * 1000 <= after


def test_chrome_trace_loads_back_as_json(tmp_path):
    path = tmp_path / "trace.json"
    _, tspec = _specs(n=64, seed=2, engine="windowed",
                      traffic=dict(kind="poisson", rate=2.0, messages=40),
                      window=dict(window=48, seg_len=4),
                      obs=dict(trace_out=str(path), provenance=2))
    before = time.time_ns()
    rep = tapi.run(tspec)
    after = time.time_ns()
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e["pid"] == 1]
    count = Counter(e["name"] for e in spans)
    segs, sweeps = rep.result.segments, rep.result.sweeps
    assert set(count) == {"engine.setup", "engine.finish", "copy.h2d",
                          "copy.d2h", *_SEGMENT_SPANS, *_SWEEP_SPANS}
    assert count["engine.setup"] == count["engine.finish"] == 1
    assert all(count[name] == segs for name in _SEGMENT_SPANS)
    assert all(count[name] == sweeps > 0 for name in _SWEEP_SPANS)
    counters = Counter(e["name"] for e in events if e.get("ph") == "C")
    assert counters == {name: segs for name in (
        "segment.activated", "segment.retired", "segment.blocked")}
    assert all(e["dur"] >= 0 for e in spans)
    assert {e["args"]["name"] for e in events if e["name"] == "thread_name"
            and e["pid"] == 1} == {"segment pipeline", "blocking copies",
                                   "engine set-up and finish"}
    assert doc["otherData"]["unix_offset_ns"] == \
        rep.obs.spans.unix_offset_ns
    _assert_unix_clock(spans, before, after)
    prov = [e for e in events if e.get("pid") == 2 and e.get("ph") == "X"]
    assert prov and any(e["name"] == "life" for e in prov)
    assert rep.obs.spans.depth == 0


# --------------------------------------------------------------------- #
# The span tree of the windowed engine and the live loop
# --------------------------------------------------------------------- #
class _TreeRecorder(SpanRecorder):
    """A recorder that also notes, as each span opens, the span it
    opens inside (None at depth 0)."""

    def __init__(self):
        super().__init__(1 << 16)
        self.edges = set()

    def begin(self, name_id):
        d = self.depth
        parent = self._names[self._stack_name[d - 1]] if d else None
        self.edges.add((parent, self._names[name_id]))
        super().begin(name_id)


def _documented_parents(kind):
    """Span -> the spans it may open inside, as ``obs/spans.py`` draws
    the tree: the batch path has no loop or tick levels."""
    live = kind == "live"
    top = "tick.advance" if live else None
    tree = {
        "engine.setup": {"loop.setup" if live else None},
        "engine.finish": {"loop.finish" if live else None},
        **{name: {top} for name in ("segment.activate", "segment.dispatch",
                                    "segment.retire")},
        **{name: {"segment.dispatch"} for name in (
            "segment.upload", "segment.enqueue", "segment.wait")},
        **{name: {"segment.retire"} for name in _SWEEP_SPANS},
        "copy.h2d": {"engine.setup", "segment.upload", "retire.reduce",
                     "retire.fold", "engine.finish"},
        "copy.d2h": {"segment.wait", "segment.snapshot", "retire.reduce",
                     "retire.fold", "engine.finish"},
    }
    if live:
        tree.update({"loop.setup": {None}, "loop.finish": {None},
                     "tick": {None}, "tick.ingest": {"tick"},
                     "tick.requeue": {"tick"}, "tick.admit": {"tick"},
                     "tick.advance": {"tick"}})
    else:
        tree["segment.snapshot"] = {None}
    return tree


def _arrays(obj):
    """A run's outputs as plain values and arrays, for exact equality."""
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
               if f.name != "scenario"}
    if isinstance(obj, dict):
        return {k: _arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_arrays(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    return obj


@functools.lru_cache(maxsize=None)
def _traced(kind, spans):
    """A small batch run (churn with a horizon, a snapshot, provenance)
    or live run (``admit`` admission, whose window overflows and whose
    segments are retried), with the tree recorder or spans off; returns
    ``(outputs, obs, time_ns before, time_ns after)``."""
    obs = EngineObs(histograms=True)
    if spans:
        obs.spans = _TreeRecorder()
    obs.flight = FlightRecorder(rate=1, seed=0, sampler="all",
                                live=kind == "live",
                                auditor=CausalAuditor("fail"))
    before = time.time_ns()
    if kind == "live":
        loop = LiveLoop(static_scenario(3, 64, k=4, m_app=0), 12,
                        device="cpu", collect="full", arrivals="bursty",
                        admission="admit", rate=8.0, messages=300,
                        queue_cap=4096, seed=11, obs=obs,
                        arrival_params=dict(period=64, duty=0.5))
        lr = loop.run()
        assert lr.overflow_catches > 0
        out = dict(report={k: v for k, v in lr.to_dict().items()
                           if k not in ("wall_seconds", "requests_per_sec")},
                   result=lr.result, submit=lr.submit_round,
                   latency=lr.latency_rounds, ticks=lr.ticks)
    else:
        scn = churn_scenario(3, 64)
        out = execute_windowed(scn, 40, device="cpu", horizon=30, seg_len=4,
                               snapshot_round=5, collect="full", obs=obs)
    after = time.time_ns()
    hist, flight = obs.latency_hist, obs.flight.export()
    return _arrays(dict(out=out, hist=hist, flight=flight)), obs, before, \
        after


@pytest.mark.parametrize("kind", ["windowed", "live"])
def test_spans_open_inside_their_documented_parents(tmp_path, kind):
    _, obs, before, after = _traced(kind, True)
    rec = obs.spans
    tree = _documented_parents(kind)
    assert {child for _, child in rec.edges} == set(tree)
    for parent, child in rec.edges:
        assert parent in tree[child], (parent, child)
    assert not any(parent is None for parent, child in rec.edges
                   if child.startswith("copy."))
    assert rec.depth == 0 and rec.dropped == 0
    kinds = Counter((e["kind"], e["name"]) for e in rec.events())
    assert kinds[("counter", "segment.activated")] == \
        kinds[("counter", "segment.retired")] == \
        kinds[("span", "segment.dispatch")] > 0
    assert kinds[("counter", "tick.queue")] == kinds[("span", "tick")]
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), rec)
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    assert len(spans) == sum(n for (k, _), n in kinds.items() if k == "span")
    _assert_unix_clock(spans, before, after)


class _LeafCount(SpanRecorder):
    """A recorder that also counts the ``leaf`` spans opened directly
    inside a ``parent`` span."""

    def __init__(self, leaf, parent):
        super().__init__(1 << 16)
        self.leaf, self.parent, self.count = leaf, parent, 0

    def inside(self, label):
        d = self.depth
        return bool(d) and self._names[self._stack_name[d - 1]] == label

    def begin(self, name_id):
        if self._names[name_id] == self.leaf and self.inside(self.parent):
            self.count += 1
        super().begin(name_id)


def test_engine_setup_uploads_the_tables_and_no_plane(monkeypatch):
    """The windowed engine's set-up uploads each (N, K) and (N,) table
    once and no (N, W) plane: the planes are filled on the device."""
    from repro_torch.core.vecsim import sim
    uploads = []
    real = sim.to_device

    def to_device(a, device, rec=sim.NULL_RECORDER):
        if rec.depth and rec.inside("engine.setup"):
            uploads.append(a.shape)
        return real(a, device, rec)

    monkeypatch.setattr(sim, "to_device", to_device)
    obs = EngineObs()
    obs.spans = _LeafCount("copy.h2d", "engine.setup")
    scn = churn_scenario(3, 64)
    w = 40
    assert scn.k != w
    out = execute_windowed(scn, w, device="cpu", seg_len=4, collect="full",
                           obs=obs)
    assert out.delivered_frac() == 1.0
    assert obs.spans.count == len(uploads) == 8
    assert sorted(uploads) == sorted([(scn.n,)] * 2 + [(scn.n, scn.k)] * 6)


@pytest.mark.parametrize("drain", [False, True])
def test_engine_finish_reads_the_tables_and_no_plane(monkeypatch, drain):
    """The windowed engine's finish copies each (N, K) and (N,) table
    once, the planes' four-value check and the drain's own read (the
    retiring columns' histogram; their broadcast flags come with the
    last sweep's aggregates), and no (N, W) plane: the drained planes
    stay on the device."""
    from repro_torch.core.vecsim import retire, stream
    reads = []
    real = stream.host

    def host(x, rec=stream.NULL_RECORDER):
        if rec.depth and rec.inside("engine.finish"):
            reads.append(tuple(x.shape))
        return real(x, rec)

    monkeypatch.setattr(stream, "host", host)
    monkeypatch.setattr(retire, "host", host)
    from repro_torch.core.vecsim.scenario import sustained_scenario
    scn = sustained_scenario(4, 48, k=4, rate=2.0, messages=60,
                             max_delay=2)
    if drain:
        # cut the run two rounds after its last broadcast, so columns
        # are still live at the finish
        scn = dataclasses.replace(
            scn, rounds=int(scn.bcast_round.max()) + 2).validate()
    obs = EngineObs(histograms=True)
    obs.spans = _LeafCount("copy.d2h", "engine.finish")
    w = 64
    stp = WindowedStepper(scn, w, device="cpu", seg_len=4,
                          collect="aggregate", obs=obs)
    while not stp.done:
        stp.advance()
    live = stp.cw.slot_msg >= 0
    n_app = int((live & stp.cw.slot_app).sum())
    assert bool(n_app) == drain
    out = stp.finish()
    drained = [(NB,)] if drain else []
    want = [(scn.n, scn.k)] * 6 + [(scn.n,)] * 2 + [(4,)] + drained
    assert sorted(reads) == sorted(want)
    assert obs.spans.count == len(want)
    assert (scn.n, w) not in reads
    assert out.state["arr"].shape == out.state["delivered"].shape == \
        (scn.n, w)


@pytest.mark.parametrize("kind", ["windowed", "live"])
def test_spans_leave_results_unchanged(kind):
    on, _, _, _ = _traced(kind, True)
    off, obs, _, _ = _traced(kind, False)
    assert not obs.spans.enabled
    assert on == off


# --------------------------------------------------------------------- #
# The causality auditor on a corrupted plane (mutation test)
# --------------------------------------------------------------------- #
def _corrupted_run(mode):
    """A windowed run whose retirement first moves one delivery of every
    sampled live column to round 0 — before its own broadcast — in the
    port's plane on the CPU."""
    obs = EngineObs(histograms=True)
    obs.flight = FlightRecorder(rate=1, seed=0, sampler="all",
                                auditor=CausalAuditor(mode))
    from repro_torch.core.vecsim.scenario import sustained_scenario
    scn = sustained_scenario(4, 48, k=4, rate=2.0, messages=60,
                             max_delay=2)
    stp = WindowedStepper(scn, 32, device="cpu", seg_len=4,
                          collect="full", obs=obs)
    orig = stp.retirer.sweep

    def corrupt(t_now):
        delivered = stp.st["delivered"]
        for c in np.nonzero((stp.cw.slot_msg > 0) & stp.cw.slot_app)[0]:
            got = torch.nonzero(delivered[:, c] >= 1).flatten()
            if len(got):
                delivered[got[0], c] = 0
        return orig(t_now)

    stp.retirer.sweep = corrupt
    while not stp.done:
        stp.advance()
    stp.finish()
    return obs.flight.auditor


def test_audit_fail_raises_on_a_corrupted_delivery_vector():
    aud = _corrupted_run("log")
    assert aud.pairs_checked > 0 and aud.violations
    for v in aud.violations:
        assert v.a_deliv > v.b_deliv >= 0
    with pytest.raises(CausalityViolationError) as ei:
        _corrupted_run("fail")
    assert ei.value.violation.a_deliv > ei.value.violation.b_deliv


# --------------------------------------------------------------------- #
# Recorder and spec surface
# --------------------------------------------------------------------- #
def test_span_recorder_matches_reference_surface():
    from repro.obs.spans import SpanRecorder as JRec
    recs = [SpanRecorder(4), JRec(4)]
    for rec in recs:
        a, b = rec.name("tick"), rec.name("tick.ingest")
        rec.begin(a)
        rec.begin(b)
        rec.end()
        rec.instant(b, 3.0)
        rec.end()
        rec.counter(a, 1.5)
        rec.counter(a, 2.5)     # the fifth event is dropped
    (got, want) = ([{k: v for k, v in e.items()
                     if k not in ("t0_ns", "dur_ns")} for e in r.events()]
                   for r in recs)
    assert got == want and recs[0].dropped == recs[1].dropped == 1
    assert recs[0].depth == 0


def test_obs_and_live_spec_defaults_track_the_reference(monkeypatch):
    # the benchmark's live driver registers its submission trace in the
    # process's arrivals table; compare the table as the port builds it
    from repro_torch.core.vecsim.live import arrivals
    monkeypatch.delitem(arrivals._ARRIVALS, "cbench.trace", raising=False)
    assert dataclasses.asdict(tapi.ObsSpec()) == \
        dataclasses.asdict(japi.ObsSpec())
    assert dataclasses.asdict(tapi.LiveSpec()) == \
        dataclasses.asdict(japi.LiveSpec())
    for name in ("SINKS", "SAMPLERS", "AUDIT", "OPS_SINKS", "ARRIVALS",
                 "ADMISSION"):
        assert sorted(getattr(tapi, name).keys()) == \
            sorted(getattr(japi, name).keys()), name


@pytest.mark.parametrize("obs,match", [
    (dict(audit="log"), "provenance"),
    (dict(sink="nope"), "obs.sink"),
    (dict(sampler="nope"), "obs.sampler"),
    (dict(ops_every=0), "ops_every"),
    (dict(ops_out="x.prom"), "mode='live'"),
    (dict(span_capacity=0), "span_capacity"),
])
def test_obs_spec_validation_matches_reference(obs, match):
    jspec, tspec = _specs(obs=obs)
    with pytest.raises(japi.SpecError, match=match):
        jspec.validate()
    with pytest.raises(tapi.SpecError, match=match):
        tspec.validate()


def test_provenance_refused_on_the_monolithic_engine():
    _, tspec = _specs(n=64, engine="vec", obs=dict(provenance=1))
    with pytest.raises(tapi.SpecError, match="streaming engine"):
        tspec.validate()


def test_percentiles_read_out_of_the_port_histogram():
    h = hist_np(np.array([0, 1, 1, 2, 40, 40, 1000]))
    assert percentiles_from_hist(h, (50.0, 99.0)) == \
        jhist.percentiles_from_hist(h, (50.0, 99.0))


def test_static_scenario_is_the_reference_builder():
    """The live base scenarios come from the port's builder copy."""
    from repro.core.vecsim.scenario import static_scenario as jss
    a, b = static_scenario(3, 32, k=4, m_app=0), jss(3, 32, k=4, m_app=0)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
