"""Structured trace spans: a preallocated monotonic-clock ring recorder
(the port's copy of the JAX package's ``repro.obs.spans``).

``SpanRecorder`` is the hot-path half of the telemetry subsystem: the
live loop and the segment drivers call ``begin``/``end`` around each
phase and ``instant``/``counter`` for point events.  The windowed
engine (``core/vecsim/stream.py``) and the live loop
(``core/vecsim/live/loop.py``) record this tree; the batch path
(``execute_windowed``) records it without the ``loop.*`` and ``tick*``
levels::

    loop.setup            LiveLoop.__init__, the window and the stepper
      engine.setup        WindowedStepper.__init__: the tables' uploads,
                          the planes filled on the card
    tick
      tick.ingest | tick.requeue | tick.admit
      tick.advance
        segment.activate  ColumnWindow.activate and the flight hook
        segment.dispatch
          segment.upload  the segment's DeviceSchedule
          segment.enqueue run_span: the segment's rounds, enqueued
          segment.wait    the series read: the host waits for the rounds
        segment.snapshot  the state read at ``snapshot_round`` (if asked)
        segment.retire
          retire.reduce   the per-column aggregates on the card
                          (core/vecsim/retire.py) and their one read
          retire.gates    the decision on the host: done, horizon
                          expiries, hung gates and the blocked count
          retire.fold     the retiring columns folded and reset, with
                          a horizon the hung gates cleared on the card
    loop.finish           LiveLoop._finalize
      engine.finish       the drain's fold, the drained planes' check on
                          the card and the (N, K) / (N,) tables' read

Every copy between host and card that the windowed engine makes is a
leaf span ``copy.h2d`` or ``copy.d2h`` at its call site, inside one of
the spans above: from pageable memory PyTorch synchronises the stream
after the copy, so each one waits for everything enqueued before it.
The counters ``segment.activated`` and ``segment.retired`` (columns a
segment), ``segment.blocked`` (live app columns delivered everywhere
that only a pending gate keeps, counted only when tracing) and
``tick.queue`` (the queue's depth after admission) are ring events on
the same timeline.

Clock: every event is taken on ``time.monotonic_ns``, and ``events()``
gives those times.  ``unix_offset_ns``, read once when the recorder is
built, moves them onto the unix clock of ``time.time_ns``, which the
device trace of ``torch.profiler`` carries; the Chrome trace writer
(``obs/sinks.py``) applies it.

Design constraints (DESIGN.md §2.10 "overhead policy"):

* zero allocation on the hot path — all event storage is preallocated
  numpy arrays, names are interned once into an id table;
* bounded memory — the ring holds ``capacity`` events and counts (not
  stores) the overflow in ``dropped``;
* a no-op twin — ``NULL_RECORDER`` has the same surface with empty
  bodies, so instrumented code never branches on "is telemetry on".

Event kinds map straight onto the Chrome trace-event phases the sink
emits: span (``"X"`` complete event), instant (``"i"``), counter
(``"C"``).

``EngineObs`` is the per-run holder the engines share: the recorder,
the merged latency histogram, gauge series, and integer counters.  It
is deliberately dumb — engines own *when* to record; this owns *where*
it all accumulates.
"""

from __future__ import annotations

import time

import numpy as np

from .hist import NB

__all__ = ["SpanRecorder", "NULL_RECORDER", "EngineObs"]

_KIND_SPAN = 0
_KIND_INSTANT = 1
_KIND_COUNTER = 2

_MAX_DEPTH = 64


def _unix_offset_ns() -> int:
    """``time.time_ns() - time.monotonic_ns()``, from the least delayed
    of a few reads of the two clocks."""
    best = None
    for _ in range(5):
        m0 = time.monotonic_ns()
        w = time.time_ns()
        m1 = time.monotonic_ns()
        cand = (m1 - m0, w - (m0 + m1) // 2)
        best = cand if best is None or cand < best else best
    return best[1]


class SpanRecorder:
    """Fixed-capacity span/instant/counter recorder on monotonic ns;
    ``unix_offset_ns`` moves its times onto the unix clock."""

    enabled = True

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.unix_offset_ns = _unix_offset_ns()
        self.kind = np.zeros(self.capacity, np.int8)
        self.name_id = np.zeros(self.capacity, np.int32)
        self.t0_ns = np.zeros(self.capacity, np.int64)
        self.dur_ns = np.zeros(self.capacity, np.int64)
        self.value = np.zeros(self.capacity, np.float64)
        self.n = 0
        self.dropped = 0
        self._names: list = []
        self._name_ids: dict = {}
        # begin/end stack: (name_id, t0_ns) pairs, fixed depth
        self._stack_name = np.zeros(_MAX_DEPTH, np.int32)
        self._stack_t0 = np.zeros(_MAX_DEPTH, np.int64)
        self._depth = 0

    @property
    def depth(self) -> int:
        """Open-span count — 0 between ticks unless a span leaked."""
        return self._depth

    def name(self, label: str) -> int:
        """Intern a label; call once at setup, not per event."""
        nid = self._name_ids.get(label)
        if nid is None:
            nid = len(self._names)
            self._names.append(label)
            self._name_ids[label] = nid
        return nid

    def begin(self, name_id: int) -> None:
        d = self._depth
        if d < _MAX_DEPTH:
            self._stack_name[d] = name_id
            self._stack_t0[d] = time.monotonic_ns()
        self._depth = d + 1

    def end(self) -> None:
        d = self._depth - 1
        if d < 0:
            return
        self._depth = d
        if d >= _MAX_DEPTH:
            return
        i = self.n
        if i >= self.capacity:
            self.dropped += 1
            return
        t1 = time.monotonic_ns()
        self.kind[i] = _KIND_SPAN
        self.name_id[i] = self._stack_name[d]
        self.t0_ns[i] = self._stack_t0[d]
        self.dur_ns[i] = t1 - self._stack_t0[d]
        self.n = i + 1

    def instant(self, name_id: int, value: float = 0.0) -> None:
        i = self.n
        if i >= self.capacity:
            self.dropped += 1
            return
        self.kind[i] = _KIND_INSTANT
        self.name_id[i] = name_id
        self.t0_ns[i] = time.monotonic_ns()
        self.dur_ns[i] = 0
        self.value[i] = value
        self.n = i + 1

    def counter(self, name_id: int, value: float) -> None:
        i = self.n
        if i >= self.capacity:
            self.dropped += 1
            return
        self.kind[i] = _KIND_COUNTER
        self.name_id[i] = name_id
        self.t0_ns[i] = time.monotonic_ns()
        self.dur_ns[i] = 0
        self.value[i] = value
        self.n = i + 1

    def events(self) -> list:
        """Recorded events as dicts (export-time only, allocates)."""
        kinds = ("span", "instant", "counter")
        out = []
        for i in range(self.n):
            ev = dict(kind=kinds[self.kind[i]],
                      name=self._names[self.name_id[i]],
                      t0_ns=int(self.t0_ns[i]))
            if self.kind[i] == _KIND_SPAN:
                ev["dur_ns"] = int(self.dur_ns[i])
            else:
                ev["value"] = float(self.value[i])
            out.append(ev)
        return out


class _NullRecorder(SpanRecorder):
    """Same surface, empty bodies: instrumentation costs one attribute
    lookup and a no-op call when telemetry is off."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=0)

    def name(self, label: str) -> int:
        return 0

    def begin(self, name_id: int) -> None:
        pass

    def end(self) -> None:
        pass

    def instant(self, name_id: int, value: float = 0.0) -> None:
        pass

    def counter(self, name_id: int, value: float) -> None:
        pass


NULL_RECORDER = _NullRecorder()


class EngineObs:
    """Per-run telemetry accumulator shared across engine layers.

    Attributes
    ----------
    histograms : bool
        Accumulate on-device delivery-latency histograms.
    spans : SpanRecorder
        Span/counter recorder (``NULL_RECORDER`` unless tracing).
    latency_hist : (NB,) int64
        Merged delivery-latency histogram over retired app columns.
    latency_base : optional (capacity,) int64
        Per-message latency reference round.  When set (live mode:
        submission round, so queueing delay counts), columns measure
        latency from ``base[msg_id]``; otherwise from column birth.
    gauges : dict[str, list]
        Per-segment gauge series (piggyback bytes, window occupancy).
    counters : dict[str, int]
        Monotonic event counts (stager uploads/skips, backpressure...).
    flight : optional FlightRecorder
        Sampled per-message provenance buffer.  ``None`` unless
        the run asked for provenance; the engines read it via
        ``getattr`` so telemetry-off paths never touch it.
    """

    def __init__(self, histograms: bool = True, spans: bool = False,
                 span_capacity: int = 65536):
        self.histograms = bool(histograms)
        self.spans = (SpanRecorder(span_capacity) if spans
                      else NULL_RECORDER)
        self.latency_hist = np.zeros(NB, np.int64)
        self.latency_base = None
        self.gauges: dict = {}
        self.counters: dict = {}
        self.flight = None

    def add_hist(self, hist) -> None:
        if self.histograms:
            self.latency_hist += np.asarray(hist, np.int64)

    def gauge(self, name: str, value) -> None:
        self.gauges.setdefault(name, []).append(value)

    def count(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta
