"""Vectorized vector-clock causal broadcast — the measured Table 1
baseline, in PyTorch on the card by default.

Runs the classic Fidge/Mattern baseline (``core.vector_clock``) on the
same lockstep-round substrate as the PC-broadcast engines, as the JAX
package's ``repro.core.vecsim.vc`` does in numpy, and byte-identical to
it.  The whole network is dense tensors on the device:

  * ``vc[p, j]``    — process ``p``'s clock entry for broadcasting origin
    ``origins[j]`` (columns are the distinct broadcast origins, sorted by
    pid; when every process broadcasts this is the full (N, N) clock);
  * ``stamp[m, j]`` — message ``m``'s piggybacked clock, fixed at its
    broadcast round from the origin's clock (own entry pre-incremented);
  * ``rcv/arr/delivered`` — (N, M) first-receipt round, earliest scheduled
    arrival, and delivery round, exactly like the PC engine's buffers.

Per round: link removals/additions (every link is usable immediately —
VC needs no link-safety gating, which is the point of the comparison),
crashes, broadcasts (origin stamps + delivers its own message, one
broadcast after another in schedule order: a second broadcast by the
same origin stamps the first one's increment), first receipts
(gossip-forward on first receipt, park in the pending set), and a
per-process delivery drain that rescans pending until a fixpoint — the
O(W·N) loop Table 1 charges this family with.

What is measured, and how faithfully:

  * **per-hop piggyback bytes** — every forwarded copy of ``m`` carries
    ``16 + 8·|entries(stamp[m])|`` bytes, the exact-engine
    ``control_bytes`` accounting for an ``AppMsg`` with a ``vc`` tuple;
  * **comparison counts** — each readiness check scans the stamp's
    present (nonzero) entries in sorted-pid order and stops at the first
    failing entry, mirroring ``VCBroadcast._ready``.  Drains fire only
    at processes that received something this round; lockstep batching
    coalesces same-round receipts into one drain, so absolute counts are
    a lower bound on the event-interleaved exact engine's;
  * **delivered multisets and final clock values** — byte-identical to
    ``core.vector_clock.VCBroadcast`` replayed on the exact event engine
    (``crossval.cross_validate(..., protocol="vc")``).

Host syncs: the round loop takes its events from per-round slices of
schedules uploaded once, and keeps every count on the device; a round
reads the rows that received something (one ``nonzero``), and the
drain reads one flag an iteration (progress made and something still
pending).  The forward is a dense ``scatter_reduce_(..., "amin")`` on
the flat ``arr`` plane, one pass a link slot.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ...backend import resolve_device
from ..types import NetStats
from .scenario import INF, VecScenario
from .sim import DeviceSchedule, full_schedule

__all__ = ["VCVecRunResult", "run_vec_vc"]

# Wire-size model shared with core.base.control_bytes: an AppMsg
# carrying a vc tuple costs id (2 ints) + one int per (pid, counter) pair.
_INT = 8


@dataclass
class VCVecRunResult:
    """Result of a vectorized vector-clock baseline run (host numpy)."""

    scenario: VecScenario
    delivered: np.ndarray        # (N, m_app) delivery round, -1 = never
    rcv: np.ndarray              # (N, m_app) first-receipt round, INF = never
    vc: np.ndarray               # (N, B) final clocks, B = distinct origins
    origins: np.ndarray          # (B,) sorted distinct broadcast origins
    stamp: np.ndarray            # (m_app, B) per-message piggybacked clocks
    state: Dict[str, np.ndarray]  # final adj/delay/active/crashed
    stats: NetStats
    series: np.ndarray           # (rounds, 3): deliveries, sent, comparisons
    comparisons: int             # total vector-entry comparisons
    max_pending: int             # peak pending-set size at any process (W)
    device: str = "cpu"
    drain_iters: Optional[np.ndarray] = None   # (rounds,) drain iterations
    drain_ms: Optional[float] = None   # drain time, when asked for

    @property
    def delivered_app(self) -> np.ndarray:
        return self.delivered

    def delivered_frac(self) -> float:
        ok = ~self.state["crashed"]
        d = self.delivered[ok]
        return float((d >= 0).mean()) if d.size else 1.0

    def mean_latency(self) -> float:
        d = self.delivered
        got = d >= 0
        if not got.any():
            return float("nan")
        lat = d - self.scenario.bcast_round[None, :]
        return float(lat[got].mean())

    def final_clocks(self) -> List[Dict[int, int]]:
        """Per-process ``{origin: delivered count}`` dicts with only the
        nonzero entries — the exact ``VCBroadcast.vc`` representation,
        for byte-level cross-validation."""
        out: List[Dict[int, int]] = []
        for p in range(self.scenario.n):
            row = self.vc[p]
            out.append({int(self.origins[j]): int(row[j])
                        for j in np.nonzero(row > 0)[0]})
        return out

    def overhead_bytes_per_message(self) -> float:
        """Measured piggyback bytes per sent copy (Table 1's O(N) term)."""
        return self.stats.control_bytes / max(self.stats.sent_messages, 1)

    def comparisons_per_delivery(self) -> float:
        """Measured vector-entry comparisons per delivery (Table 1's
        O(W·N) delivery execution time)."""
        return self.comparisons / max(self.stats.deliveries, 1)


def run_vec_vc(scn: VecScenario, device=None,
               time_drain: bool = False) -> VCVecRunResult:
    """Execute ``scn`` under the vector-clock baseline protocol on
    ``device`` (the card unless ``"cpu"`` is asked for).

    Uses only the app-broadcast schedule plus the link/crash dynamics of
    the scenario (VC has no ping phase, so the ``m_app + n_adds`` slot
    split of the PC engine collapses to ``m_app`` message columns).
    ``time_drain`` records the delivery drain's time (CUDA events on the
    card, the host clock on the CPU) in ``drain_ms``."""
    dev = resolve_device(device)
    n, k, m = scn.n, scn.k, scn.m_app
    rounds = scn.rounds
    i32, i64 = torch.int32, torch.int64

    origins = np.unique(scn.bcast_origin).astype(np.int64)
    b = len(origins)
    col_of = np.full(n, -1, np.int64)
    col_of[origins] = np.arange(b)
    bc_col_h = col_of[scn.bcast_origin]        # (m,) stamp column per message
    bc_col = torch.from_numpy(bc_col_h).to(dev)

    vc = torch.zeros((n, b), dtype=i32, device=dev)
    stamp = torch.zeros((m, b), dtype=i32, device=dev)
    arr = torch.full((n, m), int(INF), dtype=i32, device=dev)
    rcv = torch.full((n, m), int(INF), dtype=i32, device=dev)
    delivered = torch.full((n, m), -1, dtype=i32, device=dev)
    adj = torch.from_numpy(scn.adj0.astype(np.int32)).to(dev)
    delay = torch.from_numpy(scn.delay0.astype(np.int32)).to(dev)
    active = torch.from_numpy(scn.adj0 >= 0).to(dev)
    crashed = torch.zeros(n, dtype=torch.bool, device=dev)
    # the round each process crashes at, read on the host from the
    # schedule, so a broadcast's crash check never waits on the device
    crash_at = np.full(n, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(crash_at, scn.crash_pid, scn.crash_round)

    series = torch.zeros((rounds, 3), dtype=i64, device=dev)
    control_bytes = torch.zeros((), dtype=i64, device=dev)
    sent = torch.zeros((), dtype=i64, device=dev)
    max_pending = torch.zeros((), dtype=i64, device=dev)
    # per-message payload size of a forwarded copy, fixed at stamp time
    msg_bytes = torch.zeros(m, dtype=i64, device=dev)
    drain_iters = np.zeros(rounds, np.int64)
    timers = []

    ds = DeviceSchedule(full_schedule(scn), dev)
    bc_order = np.argsort(scn.bcast_round, kind="stable")
    bc_sorted = scn.bcast_round[bc_order]
    lin_self = torch.arange(n * m, dtype=i64, device=dev).view(n, m)
    col_ids = torch.arange(m, dtype=i64, device=dev)
    arr_flat = arr.view(-1)
    never = torch.full_like(arr, int(INF))

    for t in range(rounds):
        # -- 1/2/3. link removals, additions, crashes -------------------- #
        ev = ds.events("rm", t)
        if ev is not None:
            active[ev[0].long(), ev[1].long()] = False
        ev = ds.events("add", t)
        if ev is not None:
            # a scenario adds each slot at most once (validate())
            p, kk = ev[0].long(), ev[1].long()
            adj[p, kk] = ev[2]
            delay[p, kk] = ev[3]
            active[p, kk] = True               # usable immediately: no gate
        ev = ds.events("cr", t)
        if ev is not None:
            crashed[ev[0].long()] = True

        # -- 4. broadcasts: stamp from the origin's clock, deliver ------- #
        # Same-timestamp order matches the exact replay: scheduled
        # broadcasts fire before this round's arrivals, so a stamp never
        # includes a same-round receipt.  One after another: a second
        # broadcast by the same origin stamps the first's increment.
        lo, hi = np.searchsorted(bc_sorted, [t, t + 1])
        fired = []
        for i in bc_order[lo:hi].tolist():
            o = int(scn.bcast_origin[i])
            if crash_at[o] <= t:
                continue
            c = int(bc_col_h[i])
            stamp[i] = vc[o]
            stamp[i, c] += 1
            vc[o, c] += 1
            rcv[o, i] = t
            delivered[o, i] = t
            msg_bytes[i] = _INT * 2 + _INT * (stamp[i] > 0).sum()
            fired.append((o, i))

        # -- 5. first receipts: gossip-forward, park in pending ---------- #
        newly = (arr == t) & (rcv == INF) & ~crashed[:, None]
        rcv.masked_fill_(newly, t)

        # -- 6. forward this round's originations + first receipts ------- #
        send_mask = newly.clone()
        if fired:
            fo, fi = zip(*fired)
            send_mask[torch.tensor(fo, device=dev),
                      torch.tensor(fi, device=dev)] = True
        ok = active & (adj >= 0) & ~crashed[:, None]          # (N, K)
        for kk in range(k):
            sel = send_mask & ok[:, kk, None]
            lin = torch.where(sel, adj[:, kk, None].to(i64) * m + col_ids,
                              lin_self)
            val = torch.where(sel, t + delay[:, kk, None], never)
            arr_flat.scatter_reduce_(0, lin.view(-1), val.view(-1), "amin")
        copies = send_mask.to(i64) * ok.sum(dim=1, dtype=i64)[:, None]
        sent_now = copies.sum()
        sent += sent_now
        control_bytes += (copies * msg_bytes[None, :]).sum()
        series[t, 1] = sent_now

        # -- 7. delivery drain: rescan pending until a fixpoint ---------- #
        # Drains fire where something was received this round (the exact
        # engine drains on receive); a delivery can only unblock more
        # pending messages at the same process, so the fixpoint is local.
        drain_rows = torch.nonzero(newly.any(dim=1)).flatten()
        if drain_rows.numel():
            if time_drain:
                timers.append(_timer(dev))
            present = stamp > 0                               # (m, b)
            pres_cnt = present.sum(dim=1, dtype=i64)
            pres_cum = torch.cumsum(present, dim=1, dtype=i64)
            need = stamp.clone()
            need[col_ids, bc_col] -= 1                        # own entry
            vcr = vc[drain_rows]                              # (R, b)
            drow = delivered[drain_rows]                      # (R, m)
            pend = (rcv[drain_rows] != INF) & (drow < 0)      # (R, m)
            max_pending = torch.maximum(
                max_pending, pend.sum(dim=1, dtype=i64).max())
            while True:
                drain_iters[t] += 1
                fails = present[None] & (vcr[:, None, :] < need[None])
                fail_any = fails.any(dim=2)
                # first failing column: argmax returns the first maximum
                first = fails.to(torch.uint8).argmax(dim=2)
                # entries scanned by the early-exit check: all present
                # entries when ready, else present entries up to and
                # including the first failing one (sorted-pid order)
                cnt = torch.where(fail_any, pres_cum[col_ids[None, :], first],
                                  pres_cnt[None])
                scanned = (cnt * pend).sum()
                series[t, 2] += scanned
                ready = pend & ~fail_any
                drow.masked_fill_(ready, t)
                vcr.index_add_(1, bc_col, ready.to(i32))
                pend &= ~ready
                # one read an iteration: go on while the last pass
                # delivered something and something is still pending
                if not bool(ready.any() & pend.any()):
                    break
            vc[drain_rows] = vcr
            delivered[drain_rows] = drow
            if time_drain:
                timers[-1].stop()

        series[t, 0] = (delivered == t).sum()

    first_receipts = int((arr < rounds).sum())
    series_h = series.cpu().numpy()
    sent_h = int(sent)
    stats = NetStats(
        sent_messages=sent_h,
        sent_control=0,                       # VC has no ping/pong traffic
        control_bytes=int(control_bytes),
        oob_messages=0,
        deliveries=int((delivered >= 0).sum()),
        duplicate_receipts=max(0, sent_h - first_receipts),
    )
    state = dict(adj=adj.cpu().numpy(), delay=delay.cpu().numpy(),
                 active=active.cpu().numpy(), crashed=crashed.cpu().numpy())
    return VCVecRunResult(
        scenario=scn, delivered=delivered.cpu().numpy(),
        rcv=rcv.cpu().numpy(), vc=vc.cpu().numpy(), origins=origins,
        stamp=stamp.cpu().numpy(), state=state, stats=stats,
        series=series_h, comparisons=int(series_h[:, 2].sum()),
        max_pending=int(max_pending), device=str(dev),
        drain_iters=drain_iters,
        drain_ms=(sum(tm.ms() for tm in timers) if time_drain else None))


class _timer:
    """Elapsed time of a stretch of device work: CUDA events on the
    card (read after the run), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.ev[1].record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.ev[1].synchronize()
            return float(self.ev[0].elapsed_time(self.ev[1]))
        return (self.t1 - self.t0) * 1e3
