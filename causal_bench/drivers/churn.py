"""Driver of a deployment whose overlay changes: broadcasts with link
additions and removals on the streaming windowed engine.

Set-up wraps the cell's generated arrays — the overlay, the broadcasts
and the ``add_*``/``rm_*`` schedules — in the program's ``VecScenario``
(checked by ``validate()``); a repetition is one call of
``repro_torch.core.vecsim.stream.execute_windowed`` on it, with the
latency histogram on, as ``drivers/windowed.py`` runs a static cell.
With a link addition in the scenario every round takes the gated body
of ``run_span`` (``deliver_sweep``, the pong gather, ``frontier_sweep``).
The warm-up runs the schedule up to a few rounds past its first link
change through the same call at the same window, so the gated body and
the gates' retirement are built and run before the window.

A repetition keeps the program's counter events beside its spans, in
``out["counters"]`` as ``(name, value)`` pairs, for the readers of
per-layer metrics that read them.

The reference (``causal_bench.reference.churn``) works out every
broadcast's deliveries, the per-round series, ``NetStats``, the latency
histogram and the most columns the window holds from the overlay and
the schedules alone; the control runs R-broadcast (``mode="r"``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from ..gen.traffic import build_inputs
from ..reference.churn import churn_outcome
from ._judge import Rep, Verdict, outcome_wrong

__all__ = ["Cell"]

# rounds past the first link change that the warm-up runs
_WARM_PAST = 8
_CHURN = ("add_round", "add_p", "add_k", "add_q", "add_delay", "rm_round",
          "rm_p", "rm_k")


class Cell:
    """A churn deployment: ``execute_windowed`` a repetition."""

    label = "execute_windowed"

    def __init__(self, spec, seed: int, device: str):
        from repro_torch.core.vecsim.scenario import VecScenario
        self.cfg = cfg = spec.config
        self.device = device
        self.inp = inp = build_inputs(cfg, spec.traffic, seed)
        self.scn = VecScenario(
            n=inp["n"], k=inp["k"], rounds=inp["rounds"], adj0=inp["adj0"],
            delay0=inp["delay0"], bcast_round=inp["bcast_round"],
            bcast_origin=inp["bcast_origin"],
            **{f: inp[f] for f in _CHURN}, mode=cfg["protocol"],
            pong_delay=cfg["pong_delay"],
            always_gate=cfg["always_gate"]).validate()
        self._expected = None

    def _run(self, scn, spans: bool):
        from repro_torch.core.vecsim.stream import execute_windowed
        from repro_torch.obs.spans import EngineObs
        c = self.cfg
        obs = EngineObs(histograms=True, spans=spans, span_capacity=1 << 18)
        res = execute_windowed(scn, c["window"], device=self.device,
                               horizon=c["horizon"], seg_len=c["seg_len"],
                               collect=c["collect"], obs=obs)
        return res, obs

    def warm(self) -> None:
        s = self.scn
        first = [int(a.min()) for a in (s.add_round, s.rm_round) if len(a)]
        end = min(s.rounds, (min(first) if first else 0) + _WARM_PAST)
        keep = {"bcast": s.bcast_round < end, "add": s.add_round < end,
                "rm": s.rm_round < end}
        cut = {f: getattr(s, f)[keep[f.split("_")[0]]]
               for f in ("bcast_round", "bcast_origin", *_CHURN)}
        self._run(dataclasses.replace(s, rounds=end, **cut), spans=False)

    def rep(self, spans: bool = False, control: bool = False) -> Rep:
        """One repetition; ``control`` runs it with the configuration's
        control path switched on (R-broadcast: no gating)."""
        scn = (dataclasses.replace(self.scn,
                                   mode=self.cfg["control"]["mode"])
               if control else self.scn)
        t0 = time.monotonic_ns()
        res, obs = self._run(scn, spans)
        t1 = time.monotonic_ns()
        m, n = self.scn.m_app, self.scn.n
        events = obs.spans.events()
        out = dict(deliv_count=res.deliv_count[:m].copy(),
                   deliv_round_sum=res.deliv_round_sum[:m].copy(),
                   bcast_done=res.bcast_done.copy(),
                   expired=int(res.expired.sum()),
                   series=res.series.copy(),
                   stats=dataclasses.asdict(res.stats),
                   lat_sum=int(res.lat_sum), lat_cnt=int(res.lat_cnt),
                   latency_hist=obs.latency_hist.copy(),
                   peak_live=int(res.peak_live),
                   counters=[(e["name"], e["value"]) for e in events
                             if e["kind"] == "counter"])
        ev = [(e["name"], e["t0_ns"], e["t0_ns"] + e["dur_ns"])
              for e in events if e["kind"] == "span"]
        ev.append((self.label, t0, t1))
        full = int((out["deliv_count"] == n).sum())
        return Rep(t0_ns=t0, t1_ns=t1, work={"broadcasts": full},
                   offered=m, rounds=int(self.scn.rounds), out=out,
                   spans=ev)

    def expected(self, ref_device: str) -> dict:
        """The reference's answers for the cell's inputs, worked out
        once."""
        if self._expected is None:
            self._expected = churn_outcome(
                self.inp, self.cfg["seg_len"], self.cfg["pong_delay"],
                device=ref_device)
        return self._expected

    def judge(self, reps: List[Rep], ref_device: str) -> Verdict:
        exp = self.expected(ref_device)
        c, n = self.cfg, self.inp["n"]
        wrong = stats = hist = window = undelivered = expired = failed = 0
        for rep in reps:
            o = rep.out
            w = outcome_wrong(o, exp)
            wrong += int(w["per_msg"].sum())
            stats += w["stats"]
            hist += w["hist"]
            window += int(o["peak_live"] != exp["peak_live"]
                          or o["peak_live"] > c["window"])
            short = np.asarray(o["deliv_count"]) < n
            undelivered += int(short.sum())
            expired += o["expired"]
            failed += int((w["per_msg"] | short).sum())
        checks = dict(answers_wrong=(wrong, 0), stats_wrong=(stats, 0),
                      hist_wrong=(hist, 0), window_wrong=(window, 0),
                      undelivered=(undelivered, 0), expired=(expired, 0))
        return Verdict(checks=checks,
                       attempted=sum(r.offered for r in reps), failed=failed)
