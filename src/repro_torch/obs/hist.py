"""Log-bucketed delivery-latency histograms, identical on the card and
the CPU (the port's copy of the JAX package's ``repro.obs.hist``).

The bucket function is the telemetry contract shared by the numpy
reference, the torch bucketing and the ``latency_hist`` CUDA kernel:
latencies 0..15 rounds land in their own exact bucket, larger ones in
power-of-two decades, so the p50 of a healthy run is *exact* and the
tail percentiles are never more than 2x coarse.  Everything here is
integer arithmetic only — no logs, no float rounding — which is what
makes the device and host bucketings byte-identical.

Layout (``NB = 32`` buckets):

====  ==========================
 idx  latency range (rounds)
====  ==========================
0-15  exact: latency == idx
16+j  [2**(4+j), 2**(5+j)) for j in 0..14
  31  [2**19, inf)
====  ==========================

Percentiles are nearest-rank over the bucket lower bounds: the value
reported for quantile q is the lower bound of the first bucket whose
cumulative count reaches ``ceil(q/100 * total)``.  For latencies < 16
(every steady-state run in this repo) that is the *exact* nearest-rank
percentile of the sample set.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NB", "bucket_index_np", "bucket_index_torch",
           "bucket_lower_bounds", "hist_np", "merge_hists",
           "percentiles_from_hist"]

# Number of histogram buckets: 16 exact + 16 power-of-two decades.
NB = 32


def bucket_index_np(values):
    """Bucket index for each latency value (numpy reference).

    Negative values (invalid / never-delivered sentinels) bucket to 0;
    callers mask them out before accumulating.
    """
    v = np.asarray(values, np.int64)
    extra = np.zeros(v.shape, np.int64)
    for k in range(5, 20):
        extra += (v >= (1 << k)).astype(np.int64)
    return np.where(v < 16, np.clip(v, 0, 15),
                    np.minimum(16 + extra, NB - 1))


def bucket_index_torch(values):
    """Bucket index of a torch tensor — the same integer comparisons as
    :func:`bucket_index_np`, on the tensor's device."""
    v = values.to(torch.int64)
    extra = torch.zeros_like(v)
    for k in range(5, 20):
        extra += (v >= (1 << k)).to(torch.int64)
    return torch.where(v < 16, v.clamp(0, 15),
                       torch.clamp(16 + extra, max=NB - 1))


def bucket_lower_bounds() -> np.ndarray:
    """Lower latency bound of each bucket (the percentile read-out)."""
    lo = np.arange(NB, dtype=np.int64)
    lo[16:] = 1 << (4 + np.arange(NB - 16))
    return lo


def hist_np(values) -> np.ndarray:
    """Bucket a latency sample set into an ``(NB,)`` int64 histogram."""
    v = np.asarray(values, np.int64).reshape(-1)
    v = v[v >= 0]
    return np.bincount(bucket_index_np(v), minlength=NB).astype(np.int64)


def merge_hists(hists) -> np.ndarray:
    """Sum per-segment/per-column histograms into one distribution."""
    out = np.zeros(NB, np.int64)
    for h in hists:
        out += np.asarray(h, np.int64)
    return out


def percentiles_from_hist(hist, qs) -> list:
    """Nearest-rank percentiles from a bucket histogram.

    Returns the bucket lower bound (as float) holding the rank
    ``ceil(q/100 * total)`` for each q; NaN when the histogram is empty.
    """
    h = np.asarray(hist, np.int64)
    total = int(h.sum())
    if total <= 0:
        return [float("nan")] * len(list(qs))
    cum = np.cumsum(h)
    lo = bucket_lower_bounds()
    out = []
    for q in qs:
        rank = max(1, int(np.ceil(q / 100.0 * total)))
        idx = int(np.searchsorted(cum, rank, side="left"))
        out.append(float(lo[min(idx, NB - 1)]))
    return out
