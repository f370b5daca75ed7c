"""Column retirement, one path for the windowed and the sharded engine.

Between segments a column is retired — its per-message results folded
into the run's aggregates and the column recycled — exactly when
nothing in the monolithic run could still touch it:

  1. every non-crashed process has delivered it, AND no pending gated
     link could still flush it (some process delivered it at or after
     the link's gate round), for app columns;
  2. ping columns additionally stay while any live ``ping[p, k]`` slot
     references them (pong detection reads their delivery row);
  3. columns that can never become live (their broadcast was skipped by
     a crashed origin, or their link addition did not gate) retire as
     soon as their round has passed.

An optional ``horizon`` force-retires columns older than ``horizon``
rounds, flagged in ``expired``; a gate whose ping column is force-expired
can never resolve, so it is cleared on the card (its link goes safe, and
the messages it would have flushed are dropped — the documented price of
the horizon).

The decision reads one flat int64 vector, :func:`column_partials`:
``[cnt, arrcnt, sumdel, alivedel, blocked, ref, bdone]`` (``W`` each)
and ``alive``, reduced on the card from this rank's rows and summed over
the ranks.  The engines differ only in their rank group: the sum over
ranks, and the gather of row blocks for ``collect="full"`` and for the
flight recorder's rows.  On one device (:class:`OneDevice`) each is the
identity.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...obs.spans import NULL_RECORDER
from . import kernels as kx
from .scenario import INF
from .sim import host

__all__ = ["OneDevice", "resolve_collect", "column_partials",
           "retire_apply", "Retirer"]

_INF = int(INF)
_COLUMNS = ("cnt", "arrcnt", "sumdel", "alivedel", "blocked", "ref",
            "bdone")


class OneDevice:
    """The rank group of a one-device engine: rank 0 owns every row,
    and both collectives are the identity."""

    rank = off = 0

    @staticmethod
    def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
        return t

    @staticmethod
    def gather_rows(t: torch.Tensor, everywhere: bool = False):
        return t


def resolve_collect(collect: str, n: int, m_total: int) -> str:
    """``"auto"`` keeps the full ``(N, M_total)`` delivered matrix while
    it holds at most 2^26 cells and per-message aggregates beyond."""
    if collect == "auto":
        collect = "full" if n * max(m_total, 1) <= (1 << 26) else "aggregate"
    if collect not in ("full", "aggregate"):
        raise ValueError(f"unknown collect mode {collect!r}")
    return collect


def column_partials(st: Dict[str, torch.Tensor], origins: torch.Tensor,
                    rounds: int, group) -> torch.Tensor:
    """The per-column retirement aggregates, summed over the ranks: one
    int64 device tensor ``[cnt, arrcnt, sumdel, alivedel, blocked, ref,
    bdone]`` (``W`` each) followed by ``alive``.  The five plane
    reductions come from the ``retire_reduce`` kernel on the local
    rows; ``ref`` (live pings referencing the column), ``bdone`` (the
    owner rank's origin delivered it) and ``alive`` are small tensor
    operations.  ``origins`` is the per-column broadcast origin (int32
    ``(W,)``, -1 for ping and free columns)."""
    arr, delivered, crashed = st["arr"], st["delivered"], st["crashed"]
    gate, ping = st["gate"], st["ping"]
    n_loc, w = arr.shape
    gated = (gate >= 0) & st["active"] & ~crashed[:, None]
    min_gate = torch.where(gated, gate, _INF).min(dim=1).values
    cnt, alivedel, blocked, arrcnt, sumdel = kx.retire_reduce(
        arr, delivered, crashed, min_gate, rounds)
    pidx = torch.where((ping >= 0) & ~crashed[:, None], ping, w).reshape(-1)
    ref = torch.zeros(w + 1, dtype=torch.int64, device=arr.device)
    ref.scatter_add_(0, pidx.long(), torch.ones_like(pidx, dtype=torch.int64))
    ol = origins.long() - group.off
    owned = (ol >= 0) & (ol < n_loc) & (origins >= 0)
    row = delivered[ol.clamp(0, n_loc - 1),
                    torch.arange(w, device=arr.device)]
    bdone = owned & (row >= 0)
    alive = (~crashed).sum().view(1)
    out = torch.cat([x.to(torch.int64) for x in (
        cnt, arrcnt, sumdel, alivedel, blocked, ref[:w], bdone, alive)])
    return group.all_reduce_sum(out)


def retire_apply(st: Dict[str, torch.Tensor], cols: torch.Tensor,
                 app_cols: Optional[torch.Tensor],
                 hung: Optional[torch.Tensor]) -> None:
    """Recycle the retiring columns ``cols`` in place: fold the app
    deliveries of ``app_cols`` into ``ever_del`` first, clear the gates
    whose ping column is force-expired (``hung``, a ``(W,)`` mask, or
    None when there is none), then reset the columns."""
    delivered = st["delivered"]
    if app_cols is not None:
        st["ever_del"] |= (delivered.index_select(1, app_cols) >= 0).any(
            dim=1)
    if hung is not None:
        ping = st["ping"]
        w = delivered.shape[1]
        sel = (ping >= 0) & hung[ping.clamp(0, w - 1).long()]
        st["gate"].masked_fill_(sel, -1)
        st["flush"].masked_fill_(sel, _INF)
        ping.masked_fill_(sel, -1)
    st["arr"].index_fill_(1, cols, _INF)
    delivered.index_fill_(1, cols, -1)


class Retirer:
    """The retirement sweeps of one run and the per-message aggregates
    they fold: ``st`` is this rank's state on the card, ``cw`` the
    column window, ``group`` the rank group, ``put`` the engine's host
    to card copy, ``obs`` the run's telemetry or None and ``rec`` the
    recorder of the ``retire.*`` spans and the copies.  The host
    bookkeeping is built from summed values only, so it is the same on
    every rank; only rank 0 keeps the full delivered matrix."""

    def __init__(self, scn, cw, st: Dict[str, torch.Tensor],
                 horizon: Optional[int], collect: str, group, put,
                 obs=None, rec=NULL_RECORDER):
        self.scn, self.cw, self.st = scn, cw, st
        self.horizon, self.group, self.put = horizon, group, put
        self.obs, self.rec = obs, rec
        self.hist = obs is not None and obs.histograms
        self.flight = getattr(obs, "flight", None)
        self._sid = {name: rec.name(name) for name in (
            "retire.reduce", "retire.gates", "retire.fold", "copy.h2d")}
        m_total = cw.m_app_cap + scn.n_adds
        self.full = collect == "full"
        self.delivered_full = (np.full((scn.n, m_total), -1, np.int32)
                               if self.full and group.rank == 0 else None)
        self.deliv_count = np.zeros(m_total, np.int64)
        self.deliv_round_sum = np.zeros(m_total, np.int64)
        self.bcast_done = np.zeros(cw.m_app_cap, bool)
        self.expired = np.zeros(m_total, bool)
        self.first_receipts = self.lat_sum = self.lat_cnt = 0
        self.sweeps = self.app_sweeps = 0
        # the last partials read, valid until the next span runs
        self._red: Optional[Dict[str, np.ndarray]] = None

    def partials(self) -> torch.Tensor:
        """:func:`column_partials` of the planes as they are now."""
        cw = self.cw
        origins = np.full(len(cw.slot_msg), -1, np.int32)
        app = cw.slot_app & (cw.slot_msg >= 0)
        origins[app] = cw.bc_origin[cw.slot_msg[app]]
        return column_partials(self.st, self.put(origins), self.scn.rounds,
                               self.group)

    def stale(self) -> None:
        """A span ran: the last partials no longer describe the planes."""
        self._red = None

    def _read(self, red_dev: torch.Tensor) -> Dict[str, np.ndarray]:
        flat = host(red_dev, self.rec)
        w = len(self.cw.slot_msg)
        self._red = {name: flat[i * w:(i + 1) * w]
                     for i, name in enumerate(_COLUMNS)}
        self._red["alive"] = int(flat[-1])
        return self._red

    def sweep(self, t_now: int,
              red_dev: Optional[torch.Tensor] = None) -> Tuple[int, int]:
        """Retire every column the monolithic run could no longer touch,
        plus horizon expiries, from ``red_dev`` (the partials enqueued
        with the segment) or from partials taken now.  Returns how many
        columns were freed and, when tracing, the live app columns
        delivered everywhere that only a pending gate keeps."""
        cw, rec, sid = self.cw, self.rec, self._sid
        live = cw.slot_msg >= 0
        if not live.any():
            return 0, 0
        rec.begin(sid["retire.reduce"])
        red = self._read(self.partials() if red_dev is None else red_dev)
        rec.end()
        self.sweeps += 1
        rec.begin(sid["retire.gates"])
        full_del = red["alivedel"] == red["alive"]
        blocked = (red["blocked"] > 0) & cw.slot_app
        ref = red["ref"] > 0
        dead = (red["cnt"] == 0) & (cw.slot_birth < t_now)
        done = live & ~ref & ((full_del & ~blocked) | dead)
        by_exp = hung = np.zeros(len(live), bool)
        if self.horizon is not None:
            by_exp = live & ~done & (t_now - cw.slot_birth > self.horizon)
            hung = by_exp & ref
            done |= by_exp
        held = (int((live & full_del & blocked & ~done).sum())
                if rec.enabled else 0)
        rec.end()
        fl = self.flight
        if fl is not None and fl.open_count:
            blk = np.nonzero(live & blocked & ~done)[0]
            if len(blk):
                bids = cw.slot_msg[blk]
                m = fl.sampled_mask(bids)
                if m.any():
                    fl.on_blocked(bids[m], t_now)
        cols = np.nonzero(done)[0]
        rec.begin(sid["retire.fold"])
        self._fold(cols, by_exp[cols], red, hung, t_now)
        rec.end()
        return len(cols), held

    def drain(self, t_now: int) -> None:
        """Fold and reset every still-live column at the run's end, from
        the last sweep's partials when no span has run since."""
        cols = self.cw.live_cols()
        if len(cols):
            red = self._red if self._red is not None else self._read(
                self.partials())
            self._fold(cols, np.zeros(len(cols), bool), red, None, t_now)

    def _fold(self, cols: np.ndarray, by_expiry: np.ndarray,
              red: Dict[str, np.ndarray], hung: Optional[np.ndarray],
              t_now: int) -> None:
        """Fold the retiring columns into the aggregates, feed the
        telemetry, and recycle them (reset on the card)."""
        if not len(cols):
            return
        cw, group, rec, put, n = self.cw, self.group, self.rec, self.put, \
            self.scn.n
        ids = cw.slot_msg[cols]
        app = cw.slot_app[cols]
        cnt, sumdel = red["cnt"], red["sumdel"]
        self.deliv_count[ids] = cnt[cols]
        self.deliv_round_sum[ids] = sumdel[cols]
        self.first_receipts += int(red["arrcnt"][cols].sum())
        self.expired[ids] |= by_expiry
        delivered = self.st["delivered"]
        cols_t = put(cols)
        if self.full:
            rows = group.gather_rows(delivered.index_select(1, cols_t))
            if rows is not None:
                self.delivered_full[:, ids] = host(rows, rec)[:n]
        acols_t = None
        if app.any():
            acols, aidx = cols[app], ids[app]
            births = cw.slot_birth[acols].astype(np.int64)
            self.lat_sum += int((sumdel[acols] - cnt[acols] * births).sum())
            self.lat_cnt += int(cnt[acols].sum())
            self.bcast_done[aidx] = red["bdone"][acols] > 0
            self.app_sweeps += 1
            acols_t = put(acols)
            if self.hist:
                # latency histogram fold, once per column at retirement,
                # from the live plane: the base is the column's birth
                # round (batch) or the live loop's submission round
                lb = self.obs.latency_base
                base = (lb[aidx] if lb is not None
                        else cw.slot_birth[acols]).astype(np.int32)
                base_t = put(base)
                # the wrapper copies the host column list to the card
                rec.begin(self._sid["copy.h2d"])
                h = kx.latency_hist(base_t, delivered, torch.from_numpy(acols))
                rec.end()
                self.obs.add_hist(host(group.all_reduce_sum(
                    h.sum(dim=0, dtype=torch.int64)), rec))
            fl = self.flight
            if fl is not None and fl.open_count:
                # sampled provenance: the per-receiver delivery rounds of
                # the retiring *sampled* app columns, before the reset
                m = fl.sampled_mask(aidx)
                if m.any():
                    rows = group.gather_rows(
                        delivered.index_select(1, put(acols[m])),
                        everywhere=True)
                    fl.on_retire(aidx[m], host(rows, rec)[:n], t_now,
                                 by_expiry[app][m])
        retire_apply(self.st, cols_t, acols_t,
                     put(hung) if hung is not None and hung.any() else None)
        cw.free_cols(cols)

    def result_fields(self) -> dict:
        """The :class:`~repro_torch.core.vecsim.stream.WindowedRunResult`
        fields built from the aggregates."""
        return dict(delivered=self.delivered_full,
                    deliv_count=self.deliv_count,
                    bcast_done=self.bcast_done, expired=self.expired,
                    lat_sum=self.lat_sum, lat_cnt=self.lat_cnt,
                    deliv_round_sum=self.deliv_round_sum,
                    sweeps=self.sweeps, app_sweeps=self.app_sweeps)
