"""The rank group of the sharded engine: who owns which process rows,
and the three collectives the engine needs.

One ``torch.distributed`` process group partitions the process axis:
rank ``r`` of ``world`` owns the row block ``[off, off + n_loc)`` with
``off = r * n_loc`` of every per-process plane; message columns and link
slots stay whole on every rank.  The collectives:

  * :meth:`ShardGroup.ring_shift` — one forward hop of the ring (rank
    ``r`` sends to ``r + 1`` and receives from ``r - 1``), the
    counterpart of ``lax.ppermute`` over the JAX mesh's shift;
  * :meth:`ShardGroup.all_reduce_sum` — int64 sums (per-round stats,
    per-column retirement aggregates, latency histograms);
  * :meth:`ShardGroup.gather_rows` — the row blocks of every rank,
    concatenated in rank order, for the full delivered matrix, the
    snapshots and the final state (on rank 0) and for provenance (on
    every rank, so the host bookkeeping stays replicated).

At world size 1 no collective is called.  Ranks on the CPU talk over
gloo; ranks on the card over NCCL, one card a rank (``api.run`` starts
them).  The host-only pieces (``pad_rows``, ``inverse_tables``,
``topology_digest``) are numpy, copies of the JAX package's
``repro.core.vecsim.shard.mesh``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ShardGroup", "resolve_world", "require_cards", "pad_rows",
           "inverse_tables", "topology_digest"]


def require_cards(devices: int, device: torch.device) -> None:
    """On the card route, raise unless ``torch.cuda.device_count()``
    shows a card for each of ``devices`` ranks (NCCL runs one rank a
    card)."""
    if device.type == "cuda" and devices > torch.cuda.device_count():
        raise RuntimeError(
            f"the sharded engine was asked for {devices} ranks on the card "
            f"but torch sees {torch.cuda.device_count()} CUDA device(s); "
            "NCCL runs one rank a card")


def resolve_world(devices: Optional[int], device: torch.device
                  ) -> Tuple[int, int]:
    """``(rank, world)`` of this process for a run asking for
    ``devices`` ranks (``None``: whatever the process group has, 1
    without one).

    There is no silent shrink: asking for more ranks than the process
    group has, for several ranks without a process group (start them
    with ``repro_torch.api.run``), or on the card for more ranks than
    ``torch.cuda.device_count()`` shows raises."""
    if devices is not None:
        devices = int(devices)
        if devices < 1:
            raise ValueError(f"devices={devices} must be >= 1")
    if devices is not None:
        require_cards(devices, device)
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if devices is not None and devices != world:
            raise RuntimeError(f"the sharded engine was asked for {devices} "
                               f"ranks inside a process group of {world}")
        return rank, world
    if devices not in (None, 1):
        raise RuntimeError(
            f"the sharded engine was asked for {devices} ranks but no "
            "process group is initialized; start the ranks with "
            "repro_torch.api.run (shard.devices), or initialize "
            "torch.distributed in each of them")
    return 0, 1


@dataclass(frozen=True)
class ShardGroup:
    """This rank's place in the sharded engine: ``rank`` of ``world``,
    the torch ``device`` its planes live on, and ``off``, the global
    index of its first process row."""

    rank: int
    world: int
    device: torch.device
    off: int

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """One forward ring hop: this rank's ``t`` goes to rank
        ``rank + 1``; returns what rank ``rank - 1`` sent."""
        if self.world == 1:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, (self.rank + 1) % self.world),
            dist.P2POp(dist.irecv, out, (self.rank - 1) % self.world)])
        for req in reqs:
            req.wait()
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum of ``t`` over the ranks (exact for the
        integer tensors the engine reduces)."""
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def gather_rows(self, t: torch.Tensor, everywhere: bool = False
                    ) -> Optional[torch.Tensor]:
        """The ranks' equal-sized row blocks ``t`` concatenated in rank
        order — on rank 0 only (None elsewhere), or on every rank with
        ``everywhere``."""
        if self.world == 1:
            return t
        t = t.contiguous()
        if everywhere:
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t)
            return torch.cat(parts)
        parts = ([torch.empty_like(t) for _ in range(self.world)]
                 if self.rank == 0 else None)
        dist.gather(t, parts, dst=0)
        return torch.cat(parts) if self.rank == 0 else None


def topology_digest(adj: np.ndarray, delay: np.ndarray,
                    active: np.ndarray) -> bytes:
    """Content key of a topology snapshot, for caching the
    :func:`inverse_tables` build across quiescent segments (churn that
    cycles back to a topology seen before hits the cache)."""
    h = hashlib.blake2b(digest_size=16)
    for a in (adj, delay, active):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def pad_rows(n: int, n_devices: int) -> int:
    """Process-axis length padded up to a multiple of the rank count.
    Padding rows are inert (no links, never an arrival, crashed) and are
    sliced off every host-side export."""
    return -(-n // n_devices) * n_devices


def inverse_tables(adj: np.ndarray, delay: np.ndarray, active: np.ndarray):
    """Per-delay-class inverse adjacency for the fast body.

    The fast body propagates a round's delivery frontier by *gathering*
    at the receiver: each global row ``q`` OR-combines the bit-packed
    frontier rows of its eligible in-neighbours.  One table per distinct
    link delay ``dl`` (the fold value is ``t + dl``):

        ``sig``  — tuple of ``(dl, B_dl)`` (``B_dl`` = the largest
                   in-degree within the class);
        ``tabs`` — matching ``(N, B_dl)`` int32 arrays of global source
                   rows, padded with ``N`` ("no source").

    Sender eligibility (``active & (adj >= 0)``) is folded in at build
    time, which is why the fast body runs only on segments without link
    additions or removals.  A crashed sender's frontier row is all zero,
    so crashes need no entry; duplicate parallel links give duplicate
    entries, which the OR absorbs."""
    n = adj.shape[0]
    mask = active & (adj >= 0)
    src, slot = np.nonzero(mask)
    tgt = adj[src, slot].astype(np.int64)
    dls = delay[src, slot].astype(np.int64)
    sig = []
    tabs = []
    for dl in np.unique(dls):
        m = dls == dl
        t_, s_ = tgt[m], src[m]
        order = np.argsort(t_, kind="stable")
        t_, s_ = t_[order], s_[order]
        cnt = np.bincount(t_, minlength=n)
        b = max(1, int(cnt.max()))
        starts = np.concatenate([[0], np.cumsum(cnt)])
        pos = np.arange(len(t_)) - starts[t_]
        tab = np.full((n, b), n, np.int32)
        tab[t_, pos] = s_
        sig.append((int(dl), b))
        tabs.append(tab)
    return tuple(sig), tabs
