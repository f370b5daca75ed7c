"""What the engines must report for a set of broadcasts on a static
overlay, worked out from the flood tables (:mod:`.flood`) alone.

For broadcast ``m`` (origin ``o``, round ``r``) in a run of ``rounds``
rounds, with ``base`` the round its latency counts from:

* ``deliv_count[m]`` — processes at distance ``d`` with ``r + d <
  rounds``, and ``deliv_round_sum[m]`` the sum of their ``r + d``;
* ``bcast_done[m]`` — the origin delivered it (``r < rounds``);
* the per-round series the engines keep — deliveries, sends (every
  delivery goes out over each populated out-slot of the process), and
  zero pings, flushes, pongs and gates, as a static overlay has none;
* first receipts — cells whose first copy arrives before ``rounds`` —
  and from them ``NetStats`` (16 bytes an application send, 24 a ping:
  the engines' wire-size model);
* ``lat_sum``/``lat_cnt`` and the latency histogram, each delivery's
  ``r + d - base`` in the 32 log buckets (16 exact rounds, then powers
  of two), the telemetry's bucket rule.

It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .flood import FloodTables

__all__ = ["NB", "bucket_index", "outcome", "netstats"]

NB = 32
SERIES_FIELDS = ("deliveries", "sent_app", "sent_ping", "flush_sent",
                 "pongs", "gated")


def bucket_index(v: np.ndarray) -> np.ndarray:
    """Latencies 0..15 in their own bucket, ``[2**(4+j), 2**(5+j))`` in
    bucket ``16 + j``, the rest in bucket 31."""
    v = np.asarray(v, np.int64)
    extra = np.zeros(v.shape, np.int64)
    for k in range(5, 20):
        extra += (v >= (1 << k)).astype(np.int64)
    return np.where(v < 16, np.clip(v, 0, 15), np.minimum(16 + extra, NB - 1))


def netstats(series: np.ndarray, first_receipts: int) -> Dict[str, int]:
    deliveries, sent_app, sent_ping, flush_sent, pongs, _ = (
        int(x) for x in series.sum(axis=0))
    sent = sent_app + sent_ping + flush_sent
    return dict(sent_messages=sent, sent_control=sent_ping + pongs,
                control_bytes=16 * (sent_app + flush_sent) + 24 * sent_ping,
                oob_messages=pongs, deliveries=deliveries,
                duplicate_receipts=max(0, sent - first_receipts))


def _cut_sums(table: np.ndarray, origin: np.ndarray, limit: np.ndarray,
              weight_by_d: bool) -> np.ndarray:
    """Per broadcast, the sum over ``d < limit`` of ``table[origin, d]``
    (times ``d`` with ``weight_by_d``)."""
    width = table.shape[1]
    t = table * np.arange(width)[None, :] if weight_by_d else table
    cum = np.concatenate([np.zeros((len(t), 1), np.int64),
                          np.cumsum(t, axis=1)], axis=1)
    return cum[origin, np.clip(limit, 0, width)]


def outcome(ft: FloodTables, rnd: np.ndarray, origin: np.ndarray,
            base: np.ndarray, rounds: int, series_rounds: int) -> Dict:
    """The reference's answers for the broadcasts ``(rnd, origin)``,
    with the series over ``series_rounds`` rounds."""
    rnd = np.asarray(rnd, np.int64)
    origin = np.asarray(origin, np.int64)
    base = np.asarray(base, np.int64)
    limit = rounds - rnd
    cnt = _cut_sums(ft.cnt, origin, limit, False)
    dsum = _cut_sums(ft.cnt, origin, limit, True)
    first = int(_cut_sums(ft.arv, origin, limit, False).sum())
    width = ft.cnt.shape[1]
    d = np.arange(width)[None, :]
    when = rnd[:, None] + d
    ok = when < min(rounds, series_rounds)
    w_cnt = ft.cnt[origin] * ok
    series = np.zeros((series_rounds, len(SERIES_FIELDS)), np.int64)
    at = np.where(ok, when, 0).ravel()
    series[:, 0] = np.bincount(at, w_cnt.ravel(), series_rounds).astype(
        np.int64)[:series_rounds]
    series[:, 1] = np.bincount(at, (ft.deg[origin] * ok).ravel(),
                               series_rounds).astype(np.int64)[:series_rounds]
    lat = np.where(ok, when - base[:, None], 0)
    hist = np.bincount(bucket_index(lat).ravel(), w_cnt.ravel(),
                       NB).astype(np.int64)
    return dict(deliv_count=cnt, deliv_round_sum=rnd * cnt + dsum,
                bcast_done=rnd < rounds, series=series,
                first_receipts=first,
                stats=netstats(series, first),
                lat_sum=int(dsum.sum()), lat_cnt=int(cnt.sum()),
                latency_hist=hist)
