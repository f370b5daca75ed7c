"""The plain reference of a flood over a static overlay.

On a static overlay with no crash and no link change, PC-broadcast
(Algorithm 2 of arXiv:1805.05201) and R-broadcast alike deliver a
broadcast at process ``q`` at its origin's round plus the length of
the shortest delay-weighted path from the origin to ``q``: every
process forwards what it delivers over all of its links in the round
it delivers it, and a message is delivered in the round it first
arrives.  So everything the engines report about such a broadcast
follows from the distances out of its origin.

:func:`flood_tables` works those out for every origin, in blocks of
origins, by Bellman-Ford relaxation over the out-link table in plain
PyTorch (on the card where the harness runs it, on the CPU in the
tests), and keeps per origin only histograms over the distance:

* ``cnt[o, d]`` — processes at distance ``d`` from ``o``;
* ``deg[o, d]`` — the out-links those processes send over;
* ``arv[o, a]`` — processes whose first copy arrives ``a`` rounds
  after the broadcast (the origin included: its first copy comes back
  from an in-neighbour);
* ``reach[o]`` and ``ecc[o]`` — processes reached, and the largest
  distance.

It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["FloodTables", "flood_tables"]

_INF = 2 ** 30


@dataclass
class FloodTables:
    cnt: np.ndarray      # (n, D) int64
    deg: np.ndarray      # (n, D) int64
    arv: np.ndarray      # (n, A) int64
    reach: np.ndarray    # (n,) int64
    ecc: np.ndarray      # (n,) int64, -1 where not every process is reached


def _hist(rows: torch.Tensor, vals: torch.Tensor, width: int, s: int,
          weights: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(s * width, dtype=torch.int64, device=vals.device)
    out.scatter_add_(0, rows * width + vals, weights)
    return out.view(s, width)


def flood_tables(adj0: np.ndarray, delay0: np.ndarray, device="cpu",
                 block: int = 1024) -> FloodTables:
    n, k = adj0.shape
    dev = torch.device(device)
    adj = torch.as_tensor(np.asarray(adj0, np.int64), device=dev)
    dly = torch.as_tensor(np.asarray(delay0, np.int64), device=dev)
    used = adj >= 0
    src = torch.arange(n, device=dev).repeat_interleave(k)[used.reshape(-1)]
    dst = adj.reshape(-1)[used.reshape(-1)]
    edly = dly.reshape(-1)[used.reshape(-1)].to(torch.int32)
    outdeg = used.sum(dim=1).to(torch.int64)
    cnts, degs, arvs, reach, ecc = [], [], [], [], []
    for b0 in range(0, n, block):
        s = min(block, n - b0)
        rows = torch.arange(s, device=dev)
        dist = torch.full((s, n), _INF, dtype=torch.int32, device=dev)
        dist[rows, b0 + rows] = 0
        idx = dst.expand(s, -1)
        while True:
            cand = dist[:, src] + edly
            new = dist.scatter_reduce(1, idx, cand, reduce="amin")
            if torch.equal(new, dist):
                break
            dist = new
        arrive = torch.full_like(dist, _INF).scatter_reduce(
            1, idx, dist[:, src] + edly, reduce="amin")
        got = dist < _INF
        reach.append(got.sum(dim=1))
        ecc.append(torch.where(got.all(dim=1),
                               torch.where(got, dist, 0).amax(dim=1), -1))
        r, q = torch.nonzero(got, as_tuple=True)
        d = dist[r, q].to(torch.int64)
        width = int(d.max()) + 1
        cnts.append(_hist(r, d, width, s, torch.ones_like(d)).cpu().numpy())
        degs.append(_hist(r, d, width, s, outdeg[q]).cpu().numpy())
        r, q = torch.nonzero(arrive < _INF, as_tuple=True)
        a = arrive[r, q].to(torch.int64)
        arvs.append(_hist(r, a, int(a.max()) + 1 if len(a) else 1, s,
                          torch.ones_like(a)).cpu().numpy())
        del dist, arrive, cand, new

    def stack(parts):
        width = max(p.shape[1] for p in parts)
        return np.concatenate([np.pad(p, ((0, 0), (0, width - p.shape[1])))
                               for p in parts])

    return FloodTables(cnt=stack(cnts), deg=stack(degs), arv=stack(arvs),
                       reach=torch.cat(reach).cpu().numpy().astype(np.int64),
                       ecc=torch.cat(ecc).cpu().numpy().astype(np.int64))
