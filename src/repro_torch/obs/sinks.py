"""Telemetry export sinks: versioned JSONL metrics and Chrome trace JSON
(the port's copy of the JAX package's ``repro.obs.sinks``).

Two write-side formats, both schema-versioned:

* **JSONL metrics** (``write_metrics_jsonl``): first line is a header
  ``{"schema": "repro.obs.metrics", "version": 1, ...}``; every
  following line is one metric record with ``kind`` in
  ``{"summary", "hist", "gauge", "counter", "provenance"}``.
  Grep-able, append-able, and the round-trip loader validates the
  header before parsing.

* **Chrome trace-event JSON** (``write_chrome_trace``): the
  ``{"traceEvents": [...]}`` object format loadable in Perfetto /
  ``chrome://tracing``.  Spans become ``"X"`` complete events (ts/dur
  in microseconds, ts on the unix clock), instants ``"i"`` with thread
  scope, counters ``"C"``.

``SINKS`` maps the ``ObsSpec.sink`` key to a writer; it is wrapped by
the ``repro_torch.api`` registry for ``--list`` discovery.
"""

from __future__ import annotations

import json

import numpy as np

from .hist import NB, bucket_lower_bounds

__all__ = ["METRICS_SCHEMA", "METRICS_VERSION", "MetricsSink", "SINKS",
           "load_metrics_jsonl", "write_chrome_trace",
           "write_metrics_chrome", "write_metrics_jsonl"]

METRICS_SCHEMA = "repro.obs.metrics"
METRICS_VERSION = 1


class MetricsSink:
    """A named metrics writer: ``write(path, doc)``."""

    def __init__(self, key: str, write, description: str):
        self.key = key
        self.write = write
        self.description = description


def _metric_lines(doc: dict):
    """Flatten a telemetry doc into schema'd JSONL records."""
    yield dict(schema=METRICS_SCHEMA, version=METRICS_VERSION,
               kind="header", run=doc.get("run", {}))
    for name, value in sorted(doc.get("summary", {}).items()):
        yield dict(kind="summary", name=name, value=value)
    hist = doc.get("latency_hist")
    if hist is not None:
        yield dict(kind="hist", name="delivery_latency_rounds",
                   buckets=NB,
                   lower_bounds=[int(b) for b in bucket_lower_bounds()],
                   counts=[int(c) for c in np.asarray(hist, np.int64)])
    for name, series in sorted(doc.get("gauges", {}).items()):
        yield dict(kind="gauge", name=name,
                   values=[float(v) for v in series])
    for name, value in sorted(doc.get("counters", {}).items()):
        yield dict(kind="counter", name=name, value=int(value))
    for rec in doc.get("provenance") or []:
        yield dict(kind="provenance", **rec)


def write_metrics_jsonl(path: str, doc: dict) -> None:
    with open(path, "w") as fh:
        for rec in _metric_lines(doc):
            fh.write(json.dumps(rec) + "\n")


def load_metrics_jsonl(path: str) -> dict:
    """Load + validate a metrics JSONL file back into a doc."""
    with open(path) as fh:
        lines = [json.loads(ln) for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty metrics file")
    head = lines[0]
    if head.get("schema") != METRICS_SCHEMA:
        raise ValueError(f"{path}: not a {METRICS_SCHEMA} file "
                         f"(schema={head.get('schema')!r})")
    if head.get("version") != METRICS_VERSION:
        raise ValueError(f"{path}: metrics version "
                         f"{head.get('version')!r} != {METRICS_VERSION}")
    doc: dict = dict(run=head.get("run", {}), summary={}, gauges={},
                     counters={}, latency_hist=None, provenance=[])
    for rec in lines[1:]:
        kind = rec.pop("kind", None)
        if kind == "summary":
            doc["summary"][rec["name"]] = rec["value"]
        elif kind == "hist":
            doc["latency_hist"] = np.asarray(rec["counts"], np.int64)
        elif kind == "gauge":
            doc["gauges"][rec["name"]] = rec["values"]
        elif kind == "counter":
            doc["counters"][rec["name"]] = int(rec["value"])
        elif kind == "provenance":
            doc["provenance"].append(rec)
        else:
            raise ValueError(f"{path}: unknown metric kind {kind!r}")
    return doc


# Span-name families -> named thread tracks, so traces read without the
# code open.  First component of the dotted span name picks the track.
_SPAN_TRACKS = {
    "tick": (1, "serving loop"),
    "backpressure": (1, "serving loop"),
    "loop": (1, "serving loop"),
    "segment": (2, "segment pipeline"),
    "retire": (2, "segment pipeline"),
    "stager": (3, "schedule stager"),
    "engine": (5, "engine set-up and finish"),
    "copy": (6, "blocking copies"),
}
_DEFAULT_TRACK = (4, "engine misc")


def _span_track(name: str) -> tuple:
    return _SPAN_TRACKS.get(name.split(".", 1)[0], _DEFAULT_TRACK)


def write_chrome_trace(path: str, recorder, run_args: dict | None = None,
                       pid: int = 1,
                       extra_events: list | None = None) -> None:
    """Write the recorder's events as Perfetto-loadable Chrome trace JSON.

    ``ts`` is in microseconds on the unix clock (the recorder's
    monotonic times plus its ``unix_offset_ns``, which the trace's
    ``otherData`` records), the clock of ``torch.profiler``'s device
    events, so a profiler trace of the same process lines up with it
    gap by gap.  Spans/instants land on named thread tracks by
    span-name family (``tick*``/``loop.*`` -> "serving loop",
    ``segment.*``/``retire.*`` -> "segment pipeline", ``stager.*`` ->
    "schedule stager", ``engine.*`` -> "engine set-up and finish",
    ``copy.*`` -> "blocking copies").  ``extra_events`` (already
    trace-event dicts, e.g. provenance tracks from
    ``repro_torch.obs.flight.provenance_trace_events``) are appended verbatim.
    """
    events = recorder.events()
    offset = recorder.unix_offset_ns
    out = []
    if run_args:
        out.append(dict(name="process_name", ph="M", pid=pid, tid=0,
                        args=dict(name="repro.run")))
        out.append(dict(name="run_args", ph="M", pid=pid, tid=0,
                        args=run_args))
    tracks: dict = {}
    for ev in events:
        ts = (ev["t0_ns"] + offset) / 1000.0
        if ev["kind"] == "span":
            tid, label = _span_track(ev["name"])
            tracks.setdefault(tid, label)
            out.append(dict(name=ev["name"], ph="X", cat="repro",
                            ts=ts, dur=ev["dur_ns"] / 1000.0,
                            pid=pid, tid=tid))
        elif ev["kind"] == "instant":
            tid, label = _span_track(ev["name"])
            tracks.setdefault(tid, label)
            out.append(dict(name=ev["name"], ph="i", cat="repro",
                            ts=ts, s="t", pid=pid, tid=tid,
                            args=dict(value=ev["value"])))
        else:
            out.append(dict(name=ev["name"], ph="C", cat="repro",
                            ts=ts, pid=pid,
                            args={ev["name"]: ev["value"]}))
    for tid, label in sorted(tracks.items()):
        out.append(dict(name="thread_name", ph="M", pid=pid, tid=tid,
                        args=dict(name=label)))
    if extra_events:
        out.extend(extra_events)
    with open(path, "w") as fh:
        json.dump(dict(traceEvents=out, displayTimeUnit="ms",
                       otherData=dict(clock="unix",
                                      unix_offset_ns=offset)), fh)


def write_metrics_chrome(path: str, doc: dict) -> None:
    """Metrics doc as Chrome trace counter tracks (per-segment gauges
    become "C" events over a segment-index timeline, 1 ms per segment).

    Counter tracks are prefixed with the run's engine (and device
    count) so series from different runs merged into one Perfetto
    session land on distinct tracks instead of colliding by bare name.
    """
    run = doc.get("run") or {}
    eng = str(run.get("engine") or "run")
    dev = run.get("devices")
    prefix = f"{eng}[d{int(dev)}]" if dev else eng
    out = [dict(name="process_name", ph="M", pid=1, tid=0,
                args=dict(name=f"repro.metrics {prefix}"))]
    for name, series in sorted(doc.get("gauges", {}).items()):
        track = f"{prefix}/{name}"
        for i, v in enumerate(series):
            out.append(dict(name=track, ph="C", cat="repro",
                            ts=i * 1000.0, pid=1,
                            args={track: float(v)}))
    for name, value in sorted(doc.get("counters", {}).items()):
        track = f"{prefix}/{name}"
        out.append(dict(name=track, ph="C", cat="repro", ts=0.0, pid=1,
                        args={track: float(value)}))
    with open(path, "w") as fh:
        json.dump(dict(traceEvents=out, displayTimeUnit="ms"), fh)


SINKS = {
    "jsonl": MetricsSink(
        "jsonl", write_metrics_jsonl,
        "schema-versioned JSONL metrics (header line + one record per "
        "summary/hist/gauge/counter)"),
    "chrome-trace": MetricsSink(
        "chrome-trace", write_metrics_chrome,
        "per-segment gauges/counters as Chrome-trace counter tracks "
        "(Perfetto-loadable; spans always export via --trace-out)"),
}
