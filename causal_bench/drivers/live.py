"""Driver of a live serving deployment on the streaming windowed engine.

Set-up wraps the cell's overlay in a broadcast-free ``VecScenario``
(checked by ``validate()``) and draws the open-loop submission trace;
the trace reaches the program's serving loop through its arrivals
registry under the name ``cbench.trace``, so the loop serves exactly
the submissions the reference reads.  A repetition is one serving
session, ``repro_torch.core.vecsim.live.loop.LiveLoop(...).run()``:
the loop's construction, every tick (ingest, admission, one segment of
the windowed engine) and its report.  ``on_tick`` stamps the host clock
at the end of each tick.  The warm-up serves the whole trace once
through the same loop: a process's first session runs every tick ~40%
slower on the host (ingest 4x, ``segment.retire`` 2x) however much of
the spike a shorter warm-up covers, and the sessions after it do not,
so the first one belongs to set-up (``warm_info`` says what it
reached: backpressure, the queue's peak, the window full).

The reference (``causal_bench.reference``) replays the admission
policy tick by tick and works out every admitted request's deliveries,
the series, ``NetStats``, the latency histogram (from the submission
round) and the most columns held.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from ..gen.traffic import build_inputs
from ..reference.flood import flood_tables
from ..reference.outcome import outcome
from ..reference.serve import serve, serving_bound
from ._judge import Rep, Verdict, outcome_wrong

__all__ = ["Cell"]

ARRIVALS_KEY = "cbench.trace"

def _trace(rng, n, rate, messages, params):
    """The pre-drawn trace handed in through ``arrival_params``."""
    return params["rounds"][:messages], params["origins"][:messages]


def _register() -> None:
    from repro_torch.api import ARRIVALS
    from repro_torch.core.vecsim.live.arrivals import ArrivalProcess
    if ARRIVALS_KEY not in ARRIVALS:
        ARRIVALS.register(ARRIVALS_KEY, ArrivalProcess(
            ARRIVALS_KEY, "a submission trace drawn by the benchmark",
            _trace))


class Cell:
    """A live serving deployment: one ``LiveLoop`` session a repetition."""

    label = "LiveLoop"

    def __init__(self, spec, seed: int, device: str):
        from repro_torch.core.vecsim.scenario import VecScenario
        self.cfg = cfg = spec.config
        self.mix = spec.traffic
        self.device = device
        self.inp = inp = build_inputs(cfg, spec.traffic, seed)
        self.base = VecScenario(
            n=inp["n"], k=inp["k"], rounds=inp["rounds"], adj0=inp["adj0"],
            delay0=inp["delay0"], bcast_round=inp["bcast_round"],
            bcast_origin=inp["bcast_origin"], mode=cfg["protocol"],
            pong_delay=cfg["pong_delay"]).validate()
        _register()

    def _loop(self, rounds, origins, spans: bool, admission: str,
              stamps: list):
        from repro_torch.core.vecsim.live.loop import LiveLoop
        from repro_torch.obs.spans import EngineObs
        c = self.cfg
        obs = EngineObs(histograms=True, spans=spans, span_capacity=1 << 18)
        loop = LiveLoop(
            self.base, c["window"], engine="windowed", device=self.device,
            seg_len=c["seg_len"], horizon=c["horizon"], collect=c["collect"],
            arrivals=ARRIVALS_KEY, admission=admission,
            rate=float(self.mix["rate"]), messages=len(rounds),
            queue_cap=c["queue_cap"], per_round_cap=c["per_round_cap"],
            slo_p99=c["slo_p99"], seed=0,
            arrival_params=dict(rounds=rounds, origins=origins), obs=obs,
            on_tick=lambda info: stamps.append(time.monotonic_ns()))
        return loop, obs

    def warm(self) -> None:
        out = self.rep().out
        self.warm_info = {key: out[key] for key in (
            "ticks", "backpressure_ticks", "queue_peak", "peak_live")}

    def rep(self, spans: bool = False, control: bool = False) -> Rep:
        """One serving session; ``control`` runs it with the
        configuration's control path switched on (``shed`` admission,
        which drops what does not fit instead of deferring it)."""
        admission = (self.cfg["control"]["admission"] if control
                     else self.cfg["admission"])
        stamps: list = []
        t0 = time.monotonic_ns()
        loop, obs = self._loop(self.inp["arr_round"], self.inp["arr_origin"],
                               spans, admission, stamps)
        t_run = time.monotonic_ns()
        lr = loop.run()
        t1 = time.monotonic_ns()
        res, m = lr.result, lr.scenario.m_app
        out = dict(round=lr.scenario.bcast_round.astype(np.int64),
                   origin=lr.scenario.bcast_origin.astype(np.int64),
                   submit=lr.submit_round.astype(np.int64),
                   admitted=lr.admitted, shed=lr.shed_queue + lr.shed_policy,
                   unserved=lr.unserved, rounds=lr.rounds,
                   ticks=lr.ticks_run, queue_peak=lr.queue_peak,
                   backpressure_ticks=lr.backpressure_ticks,
                   overflow_catches=lr.overflow_catches,
                   peak_live=int(lr.peak_live),
                   deliv_count=res.deliv_count[:m].copy(),
                   deliv_round_sum=res.deliv_round_sum[:m].copy(),
                   bcast_done=res.bcast_done.copy(),
                   expired=int(res.expired.sum()),
                   series=res.series.copy(),
                   stats=dataclasses.asdict(res.stats),
                   lat_sum=int(res.lat_sum), lat_cnt=int(res.lat_cnt),
                   latency_hist=obs.latency_hist.copy())
        ev = [(e["name"], e["t0_ns"], e["t0_ns"] + e["dur_ns"])
              for e in obs.spans.events() if e["kind"] == "span"]
        ev.append((self.label, t0, t1))
        served = int((out["deliv_count"] == self.base.n).sum())
        ticks = np.diff(np.asarray([t_run] + stamps, np.int64))
        return Rep(t0_ns=t0, t1_ns=t1, work={"requests": served},
                   offered=len(self.inp["arr_round"]), rounds=lr.rounds,
                   out=out, spans=ev, tick_ns=ticks)

    def judge(self, reps: List[Rep], ref_device: str) -> Verdict:
        inp, c = self.inp, self.cfg
        ft = flood_tables(inp["adj0"], inp["delay0"], device=ref_device)
        arr_r, arr_o = inp["arr_round"], inp["arr_origin"]
        bound = serving_bound(inp["n"], inp["k"], c["max_delay"],
                              c["pong_delay"], inp["rounds"], c["window"],
                              c["seg_len"], c["per_round_cap"], len(arr_r),
                              int(arr_r[-1]))
        sv = serve(arr_r, arr_o, ft.ecc, c["window"], c["seg_len"],
                   c["per_round_cap"], c["queue_cap"], bound)
        exp = outcome(ft, sv["round"], sv["origin"], base=sv["submit"],
                      rounds=bound, series_rounds=max(1, sv["rounds"]))
        counts = ("admitted", "shed", "unserved", "rounds", "ticks",
                  "queue_peak", "backpressure_ticks")
        wrong = stats = hist = window = admission = 0
        undelivered = unserved = expired = failed = 0
        for rep in reps:
            o = rep.out
            per_req = np.zeros(max(len(o["round"]), len(sv["round"])), bool)
            for key in ("round", "origin", "submit"):
                per_req |= np.resize(_diff(o[key], sv[key]), per_req.shape)
            admission += int(per_req.sum())
            admission += sum(int(o[key] != sv[key]) for key in counts)
            admission += int(o["overflow_catches"] != 0)
            w = outcome_wrong(o, exp)
            wrong += int(w["per_msg"].sum())
            stats += w["stats"]
            hist += w["hist"]
            window += int(o["peak_live"] != sv["peak_live"]
                          or o["peak_live"] > c["window"])
            short = o["deliv_count"] < inp["n"]
            undelivered += int(short.sum())
            unserved += o["unserved"]
            expired += o["expired"]
            bad = np.resize(w["per_msg"], short.shape) | short
            failed += int(bad.sum()) + rep.offered - len(short)
        checks = dict(answers_wrong=(wrong, 0), admission_wrong=(admission, 0),
                      stats_wrong=(stats, 0), hist_wrong=(hist, 0),
                      window_wrong=(window, 0), undelivered=(undelivered, 0),
                      unserved=(unserved, 0), expired=(expired, 0))
        return Verdict(checks=checks,
                       attempted=sum(r.offered for r in reps), failed=failed)


def _diff(a, b) -> np.ndarray:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return np.ones(max(a.size, b.size), bool)
    return a != b
