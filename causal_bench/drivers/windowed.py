"""Driver of a pre-scripted deployment on the streaming windowed engine.

Set-up wraps the cell's generated arrays in the program's
``VecScenario`` (checked by ``validate()``); a repetition is one call of
``repro_torch.core.vecsim.stream.execute_windowed`` on that scenario —
the engine's plane set-up, every segment's rounds (``run_span`` and its
kernels), the retirements and the result — with the latency histogram
on, as the program's front door runs this engine.  The warm-up runs
the schedule's first rounds through the same call at the same window.

The reference (``causal_bench.reference``) works out every broadcast's
deliveries, the per-round series, ``NetStats``, the latency histogram
and the most columns the window holds from the overlay and the
schedule alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..gen.traffic import build_inputs
from ..reference.flood import flood_tables
from ..reference.outcome import outcome
from ..reference.serve import batch_columns
from ._judge import Rep, Verdict, outcome_wrong

__all__ = ["Cell"]

# rounds of the schedule the warm-up runs
_WARM_ROUNDS = 16


class Cell:
    """A pre-scripted deployment: ``execute_windowed`` a repetition."""

    label = "execute_windowed"

    def __init__(self, spec, seed: int, device: str):
        from repro_torch.core.vecsim.scenario import VecScenario
        self.cfg = cfg = spec.config
        self.device = device
        self.inp = inp = build_inputs(cfg, spec.traffic, seed)
        self.scn = VecScenario(
            n=inp["n"], k=inp["k"], rounds=inp["rounds"], adj0=inp["adj0"],
            delay0=inp["delay0"], bcast_round=inp["bcast_round"],
            bcast_origin=inp["bcast_origin"], mode=cfg["protocol"],
            pong_delay=cfg["pong_delay"]).validate()

    def _run(self, scn, spans: bool, horizon: Optional[int]):
        from repro_torch.core.vecsim.stream import execute_windowed
        from repro_torch.obs.spans import EngineObs
        c = self.cfg
        obs = EngineObs(histograms=True, spans=spans, span_capacity=1 << 18)
        res = execute_windowed(scn, c["window"], device=self.device,
                               horizon=horizon, seg_len=c["seg_len"],
                               collect=c["collect"], obs=obs)
        return res, obs

    def warm(self) -> None:
        from dataclasses import replace
        r = self.scn.bcast_round
        m = int(np.searchsorted(r, _WARM_ROUNDS // 2))
        prefix = replace(self.scn, rounds=min(self.scn.rounds, _WARM_ROUNDS),
                         bcast_round=r[:m],
                         bcast_origin=self.scn.bcast_origin[:m])
        self._run(prefix, spans=False, horizon=self.cfg["horizon"])

    def rep(self, spans: bool = False, control: bool = False) -> Rep:
        """One repetition; ``control`` runs it with the configuration's
        control path switched on (a ``horizon`` that expires columns)."""
        horizon = (self.cfg["control"]["horizon"] if control
                   else self.cfg["horizon"])
        t0 = time.monotonic_ns()
        res, obs = self._run(self.scn, spans, horizon)
        t1 = time.monotonic_ns()
        m, n = self.scn.m_app, self.scn.n
        out = dict(deliv_count=res.deliv_count[:m].copy(),
                   deliv_round_sum=res.deliv_round_sum[:m].copy(),
                   bcast_done=res.bcast_done.copy(),
                   expired=int(res.expired.sum()),
                   series=res.series.copy(),
                   stats=dataclasses.asdict(res.stats),
                   lat_sum=int(res.lat_sum), lat_cnt=int(res.lat_cnt),
                   latency_hist=obs.latency_hist.copy(),
                   peak_live=int(res.peak_live))
        ev = [(e["name"], e["t0_ns"], e["t0_ns"] + e["dur_ns"])
              for e in obs.spans.events() if e["kind"] == "span"]
        ev.append((self.label, t0, t1))
        full = int((out["deliv_count"] == n).sum())
        return Rep(t0_ns=t0, t1_ns=t1, work={"broadcasts": full},
                   offered=m, rounds=int(self.scn.rounds), out=out,
                   spans=ev)

    def judge(self, reps: List[Rep], ref_device: str) -> Verdict:
        inp, c = self.inp, self.cfg
        ft = flood_tables(inp["adj0"], inp["delay0"], device=ref_device)
        rnd, org = inp["bcast_round"], inp["bcast_origin"]
        exp = outcome(ft, rnd, org, base=rnd, rounds=inp["rounds"],
                      series_rounds=inp["rounds"])
        done = np.where(ft.ecc[org] >= 0, rnd + ft.ecc[org], -1)
        peak = batch_columns(rnd, done, inp["rounds"], c["seg_len"])
        wrong = stats = hist = window = undelivered = expired = failed = 0
        for rep in reps:
            o = rep.out
            w = outcome_wrong(o, exp)
            wrong += int(w["per_msg"].sum())
            stats += w["stats"]
            hist += w["hist"]
            window += int(o["peak_live"] != peak
                          or o["peak_live"] > c["window"])
            short = o["deliv_count"] < inp["n"]
            undelivered += int(short.sum())
            expired += o["expired"]
            failed += int((w["per_msg"] | short).sum())
        checks = dict(answers_wrong=(wrong, 0), stats_wrong=(stats, 0),
                      hist_wrong=(hist, 0), window_wrong=(window, 0),
                      undelivered=(undelivered, 0), expired=(expired, 0))
        return Verdict(checks=checks,
                       attempted=sum(r.offered for r in reps), failed=failed)
