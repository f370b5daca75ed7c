"""Live ops plane: per-tick gauges out of the serving loop (the port's
copy of the JAX package's ``repro.obs.ops``).

``OpsPlane.publish`` runs once per ``LiveLoop`` tick, assembles a flat
snapshot (queue depth, window occupancy, admission split, SLO burn rate
over a sliding window, auditor verdicts, provenance counters) and fans
it out to a streaming sink and/or the ``--watch`` terminal dashboard.

Two sink front-ends ship (``--list`` discoverable):

  prometheus   text-format snapshot, atomically rewritten every publish
               (point node_exporter's textfile collector or a file
               scraper at it)
  jsonl        append-only stream, schema header + one record per tick

The dashboard degrades to plain one-line records when the stream is not
a TTY (CI pins this), so ``--watch 2>log`` stays greppable.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

__all__ = [
    "OPS_SCHEMA", "OPS_SCHEMA_VERSION", "OPS_SINKS", "OpsSink",
    "OpsPlane", "SloBurn", "WatchDashboard",
    "write_prometheus_snapshot", "append_ops_jsonl",
]

OPS_SCHEMA = "repro.obs.ops"
OPS_SCHEMA_VERSION = 1


# --------------------------------------------------------------------- #
# Sinks
# --------------------------------------------------------------------- #
def write_prometheus_snapshot(path: str, snap: dict,
                              first: bool) -> None:
    """Rewrite ``path`` with the snapshot in Prometheus text format.

    Written to a sibling temp file and ``os.replace``d so scrapers
    never observe a torn snapshot.
    """
    lines = []
    for key in sorted(snap):
        val = snap[key]
        if val is None or isinstance(val, str):
            continue
        name = f"repro_{key}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(val):g}")
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def append_ops_jsonl(path: str, snap: dict, first: bool) -> None:
    """Append one snapshot record; the first publish truncates and
    writes the schema header line."""
    with open(path, "w" if first else "a") as fh:
        if first:
            fh.write(json.dumps(dict(
                kind="header", schema=OPS_SCHEMA,
                version=OPS_SCHEMA_VERSION)) + "\n")
        fh.write(json.dumps(dict(kind="tick", **snap)) + "\n")


def load_ops_jsonl(path: str) -> list:
    """Read back a jsonl ops stream (tests / offline analysis)."""
    ticks = []
    with open(path) as fh:
        header = json.loads(next(fh))
        if header.get("schema") != OPS_SCHEMA:
            raise ValueError(f"not an ops stream: {header!r}")
        for line in fh:
            rec = json.loads(line)
            if rec.pop("kind", None) == "tick":
                ticks.append(rec)
    return ticks


@dataclass(frozen=True)
class OpsSink:
    """A named streaming sink for per-tick ops snapshots."""
    key: str
    write: Callable[[str, dict, bool], None]
    description: str


OPS_SINKS: Dict[str, OpsSink] = {
    "prometheus": OpsSink(
        "prometheus", write_prometheus_snapshot,
        "Prometheus text-format gauge snapshot, atomically rewritten "
        "every publish (textfile-collector friendly)"),
    "jsonl": OpsSink(
        "jsonl", append_ops_jsonl,
        "append-only JSONL stream: schema header line + one snapshot "
        "record per published tick"),
}


# --------------------------------------------------------------------- #
# SLO burn rate over a sliding window
# --------------------------------------------------------------------- #
class SloBurn:
    """Fraction of recent deliveries over the latency SLO.

    Reads the engine's log-bucket latency histogram differentially: the
    per-tick delta of buckets whose *lower bound* exceeds ``slo`` is an
    under-count of over-SLO deliveries (sound: everything in such a
    bucket is over), summed across the last ``window`` ticks.
    """

    def __init__(self, slo: float, window: int = 64):
        from .hist import NB, bucket_lower_bounds
        lo = bucket_lower_bounds()
        self.thr = int(np.searchsorted(lo, float(slo), side="right"))
        self.window = max(1, int(window))
        self._prev = np.zeros(NB, np.int64)
        self._deliv: list = []
        self._over: list = []

    def update(self, hist: np.ndarray) -> float:
        h = np.asarray(hist, np.int64)
        delta = h - self._prev
        self._prev = h.copy()
        self._deliv.append(int(delta.sum()))
        self._over.append(int(delta[self.thr:].sum()))
        if len(self._deliv) > self.window:
            self._deliv.pop(0)
            self._over.pop(0)
        total = sum(self._deliv)
        return (sum(self._over) / total) if total else 0.0


# --------------------------------------------------------------------- #
# --watch terminal dashboard
# --------------------------------------------------------------------- #
class WatchDashboard:
    """In-place terminal panel; plain line-per-tick off a TTY."""

    _ROWS = (
        (("queue depth", "queue_depth"),
         ("window occupancy", "window_occupancy")),
        (("admitted (tick)", "admitted_tick"),
         ("admitted (total)", "admitted_total")),
        (("shed", "shed"), ("requeued", "requeued")),
        (("backpressure", "backpressure_events"),
         ("provenance open", "provenance_open")),
        (("audit pairs", "audit_pairs_checked"),
         ("audit violations", "audit_violations")),
    )

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr
        self.tty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._height = 0

    def render(self, snap: dict) -> None:
        burn = snap.get("slo_burn")
        burn_s = f"{burn:.1%}" if burn is not None else "n/a"
        if not self.tty:
            fields = ["queue_depth", "window_occupancy", "admitted_tick",
                      "shed", "requeued", "backpressure_events",
                      "audit_violations"]
            line = " ".join(f"{k}={snap.get(k, 0)}" for k in fields)
            print(f"ops tick={snap['tick']} t={snap['t']} {line} "
                  f"slo_burn={burn_s}", file=self.stream, flush=True)
            return
        lines = [f"repro live ops — tick {snap['tick']}  "
                 f"t={snap['t']}  slo burn {burn_s}"]
        for row in self._ROWS:
            cells = [f"{label:<18}{snap.get(key, 0):>10}"
                     for label, key in row]
            lines.append("  " + "    ".join(cells))
        out = self.stream
        if self._height:
            out.write(f"\x1b[{self._height}F\x1b[J")
        out.write("\n".join(lines) + "\n")
        out.flush()
        self._height = len(lines)


# --------------------------------------------------------------------- #
# The plane
# --------------------------------------------------------------------- #
class OpsPlane:
    """Per-tick gauge publisher wired into ``LiveLoop``."""

    def __init__(self, out: Optional[str] = None,
                 sink: str = "prometheus", every: int = 1,
                 slo_p99: Optional[float] = None, burn_window: int = 64,
                 watch=None):
        if out is not None and sink not in OPS_SINKS:
            raise KeyError(f"unknown ops sink {sink!r}; "
                           f"expected one of {sorted(OPS_SINKS)}")
        self.out = out
        self.sink = OPS_SINKS[sink] if out is not None else None
        self.every = max(1, int(every))
        self.slo_p99 = slo_p99
        self.burn_window = burn_window
        self._burn: Optional[SloBurn] = None
        if watch is True:
            watch = WatchDashboard()
        elif watch is not None and not isinstance(watch, WatchDashboard):
            watch = WatchDashboard(watch)
        self.watch: Optional[WatchDashboard] = watch
        self.ticks = 0
        self._first = True
        self._published = 0
        self.last: Optional[dict] = None

    def publish(self, loop, info: dict) -> None:
        self.ticks += 1
        obs = loop.obs
        snap = dict(
            tick=self.ticks, t=int(info["t"]),
            queue_depth=int(info["queue"]),
            window_occupancy=int(info["live"]),
            admitted_tick=int(info["admitted"]),
            admitted_total=int(info["admitted_total"]),
            shed=int(info["shed"]),
            requeued=int(loop.requeued),
            backpressure_events=int(loop.overflow_catches),
        )
        if obs is not None and obs.histograms:
            snap["delivered_total"] = int(obs.latency_hist.sum())
        if self.slo_p99 is not None and obs is not None \
                and obs.histograms:
            if self._burn is None:
                self._burn = SloBurn(self.slo_p99, self.burn_window)
            snap["slo_burn"] = round(
                self._burn.update(obs.latency_hist), 6)
        else:
            snap["slo_burn"] = None
        fl = getattr(obs, "flight", None) if obs is not None else None
        if fl is not None:
            snap["provenance_open"] = fl.open_count
            snap["provenance_completed"] = len(fl.completed)
            aud = fl.auditor
            if aud is not None:
                snap["audit_pairs_checked"] = aud.pairs_checked
                snap["audit_violations"] = len(aud.violations)
        self.last = snap
        if self.ticks % self.every == 0:
            self._emit(snap)

    def _emit(self, snap: dict) -> None:
        if self.sink is not None:
            self.sink.write(self.out, snap, self._first)
            self._first = False
        if self.watch is not None:
            self.watch.render(snap)
        self._published = self.ticks

    def close(self) -> None:
        """Flush the final snapshot if the cadence skipped it."""
        if self.last is not None and self._published != self.ticks:
            self._emit(self.last)
