"""The churn cell at small sizes on the CPU: its plain reference of a
changing overlay equals the port's windowed and monolithic engines on
every judged number, whatever the blocks its flood takes the messages
in, its count of the most columns held equals the engine's, and the judge
passes an honest repetition and fails a wrong one.  Its generator's
frozen copies draw what the program's scenario functions draw."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from causal_bench.gen.traffic import build_inputs
from causal_bench.harness.spec import load_cell, load_driver, load_file
from causal_bench.reference.churn import churn_outcome
from causal_bench.reference.outcome import bucket_index

CELL = "kreg10k.churn"
BIG_SEED = 2 ** 31 + 4321
churn_gen = load_file("gen/arrivals", "schedule.churn")


def _spec(**kw):
    """The churn cell at a CPU size: ``kw`` overrides the configuration
    (``n``, ``k``, ``window``, ``seg_len``, ``max_delay``) and the mix
    (the rest)."""
    spec = load_cell(CELL)
    cfg_keys = {"n", "k", "window", "seg_len", "max_delay", "free_slots"}
    cfg = dict(n=200, window=512)
    mix = dict(rate=8.0, messages=800, adds=8, removals=8, period=32,
               batch_rounds=8)
    for key, val in kw.items():
        (cfg if key in cfg_keys else mix)[key] = val
    spec.config.update(cfg)
    spec.traffic.update(mix)
    return spec


#: (name, overrides): N 64-512, K 5-9, W 64 up, seg_len 4-8, batches of
#: 4-16 additions and removals
SIZES = {
    "n200k9": dict(),
    "n64k5": dict(n=64, k=5, window=64, seg_len=4, rate=2.0, messages=200,
                  adds=4, removals=4, period=24),
    "n512k9d2": dict(n=512, k=9, window=1024, seg_len=8, max_delay=2,
                     rate=12.0, messages=1200, adds=16, removals=16),
    "n300k7s6": dict(n=300, k=7, window=256, seg_len=6, rate=6.0,
                     messages=600, adds=12, removals=10, period=40,
                     batch_rounds=12),
}


def _cell(size, seed):
    spec = _spec(**SIZES[size])
    return spec, load_driver(spec).Cell(spec, seed, "cpu")


def _vec_answers(scn, res):
    """The judged numbers of a monolithic ``execute_vec`` run."""
    m = scn.m_app
    d = res.delivered[:, :m].astype(np.int64)
    got = d >= 0
    lat = d - scn.bcast_round[None, :].astype(np.int64)
    return dict(
        deliv_count=got.sum(axis=0), deliv_round_sum=np.where(got, d, 0).sum(
            axis=0), bcast_done=res.delivered[scn.bcast_origin,
                                              np.arange(m)] >= 0,
        series=res.series, stats=dataclasses.asdict(res.stats),
        lat_sum=int(lat[got].sum()), lat_cnt=int(got.sum()),
        latency_hist=np.bincount(bucket_index(lat[got]), minlength=32))


def _assert_same(got, exp, keys):
    for key in keys:
        a, b = got[key], exp[key]
        if isinstance(b, dict):
            assert a == b, key
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


JUDGED = ("deliv_count", "deliv_round_sum", "bcast_done", "series",
          "stats", "lat_sum", "lat_cnt", "latency_hist")


@pytest.mark.parametrize("seed", [3, BIG_SEED])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_reference_equals_the_windowed_engine(size, seed):
    spec, cell = _cell(size, seed)
    out = cell.rep().out
    exp = cell.expected("cpu")
    _assert_same(out, exp, JUDGED)
    assert out["peak_live"] == exp["peak_live"] <= spec.config["window"]
    assert exp["gates"] > 0 and exp["series"][:, 3].sum() > 0


@pytest.mark.parametrize("seed", [5, BIG_SEED + 1])
@pytest.mark.parametrize("size", ["n64k5", "n200k9"])
def test_reference_equals_the_monolithic_engine(size, seed):
    from repro_torch.core.vecsim.sim import execute_vec
    _, cell = _cell(size, seed)
    got = _vec_answers(cell.scn, execute_vec(cell.scn, device="cpu"))
    _assert_same(got, cell.expected("cpu"), JUDGED)


@pytest.mark.parametrize("seed", [1, 9])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_blocks_of_messages_change_no_answer(size, seed):
    """The flood of the app messages gives the same answers whether it
    takes them in one block or in blocks of a few, whose floods end in
    different rounds."""
    _, cell = _cell(size, seed)
    whole = churn_outcome(cell.inp, cell.cfg["seg_len"], 1)
    parts = churn_outcome(cell.inp, cell.cfg["seg_len"], 1, block=37)
    assert len(cell.inp["bcast_round"]) > 37
    for key in (*JUDGED, "first_receipts", "peak_live", "gates"):
        a, b = parts[key], whole[key]
        assert (a == b) if isinstance(a, dict) else np.array_equal(
            np.asarray(a), np.asarray(b)), key


@pytest.mark.parametrize("seg_len,window", [(4, 160), (8, 200), (5, 512)])
def test_most_columns_held_equals_the_engine(seg_len, window):
    """The reference's count of the most columns held follows the
    engine's retirement of gate-held and ping columns, at several
    segment lengths, up to a window it fills."""
    from repro_torch.core.vecsim.stream import execute_windowed
    spec, cell = _cell("n200k9", 12)
    exp = churn_outcome(cell.inp, seg_len, 1)
    res = execute_windowed(cell.scn, max(window, exp["peak_live"]),
                           device="cpu", seg_len=seg_len,
                           collect="aggregate")
    assert res.peak_live == exp["peak_live"]
    # the gates hold columns: without them the window would hold fewer
    quiet = dict(cell.inp, add_round=cell.inp["add_round"][:0])
    for key in ("add_p", "add_k", "add_q", "add_delay"):
        quiet[key] = cell.inp[key][:0]
    assert churn_outcome(quiet, seg_len, 1)["peak_live"] < exp["peak_live"]


def test_judge_passes_an_honest_repetition_and_fails_wrong_ones():
    spec, cell = _cell("n200k9", 21)
    rep = cell.rep()
    honest = cell.judge([rep], "cpu")
    assert honest.correct and honest.failed == 0
    assert honest.attempted == spec.traffic["messages"]
    control = cell.judge([cell.rep(control=True)], "cpu")
    assert not control.correct
    assert control.checks["answers_wrong"][0] > 0 and control.failed > 0
    bent = dataclasses.replace(rep, out=dict(rep.out))
    bent.out["deliv_round_sum"] = rep.out["deliv_round_sum"].copy()
    bent.out["deliv_round_sum"][7] += 1
    verdict = cell.judge([bent], "cpu")
    assert verdict.checks["answers_wrong"][0] == 1 and not verdict.correct


def test_reference_refuses_an_addition_before_any_delivery():
    _, cell = _cell("n64k5", 2)
    inp = dict(cell.inp)
    inp["add_round"] = np.zeros_like(inp["add_round"])
    with pytest.raises(ValueError, match="delivered no app message"):
        churn_outcome(inp, 4, 1)


# --------------------------------------------------------------------- #
# the generator
# --------------------------------------------------------------------- #
def test_plan_adds_equals_the_program():
    from repro_torch.core.vecsim.scenario import _plan_adds
    adj0, _ = load_file("gen/overlays", "kregular").kregular_topology(
        BIG_SEED, 97, 6, 2, 1)
    for seed in (0, BIG_SEED):
        a = np.random.default_rng(seed)
        b = np.random.default_rng(seed)
        mine = churn_gen.plan_adds(a, 97, 6, adj0, 20, 30, 46, 2)
        theirs = _plan_adds(b, 97, 6, adj0, 20, 30, 46, 2)
        assert all(np.array_equal(x, y) for x, y in zip(mine, theirs))
        assert a.integers(0, 2 ** 62) == b.integers(0, 2 ** 62)


@pytest.mark.parametrize("seed", [4, BIG_SEED])
def test_batches_equal_churn_wave_scenario(seed):
    """Drawn in ``churn_wave_scenario``'s order — its early broadcasts,
    the shared pool, then each wave's additions, removals and
    broadcasts — the frozen copies give its arrays."""
    from repro_torch.core.vecsim import scenario as prog
    n, k, waves, per, delay = 120, 6, 3, 7, 2
    scn = prog.churn_wave_scenario(seed, n, k=k, m_app=18, waves=waves,
                                   adds_per_wave=per, rms_per_wave=per,
                                   max_delay=delay, topology="kregular")
    rng = np.random.default_rng(seed + 5)
    settle = prog.settle_rounds(n, k, delay, 1)
    gap = settle // 2 + 4
    early = max(2, 18 // (waves + 1))
    prog._spread_broadcasts(rng, n, early, 0, 2 * early)
    lo = 2 * early + settle
    pool = rng.permutation(n)
    adds = [[] for _ in range(5)]
    rms = [[] for _ in range(3)]
    seen, left = set(), 18 - early
    for wv in range(waves):
        w_lo = lo + wv * gap
        w_hi = w_lo + max(3, per)
        for acc, col in zip(adds, churn_gen.plan_adds(
                rng, n, k, scn.adj0, per, w_lo, w_hi, delay,
                procs=pool[wv * per:(wv + 1) * per])):
            acc.append(col)
        for acc, col in zip(rms, churn_gen.plan_removals(
                rng, n, k, scn.adj0, per, w_lo, w_hi, seen)):
            acc.append(np.asarray(col, np.int64))
        m_wave = left // (waves - wv)
        left -= m_wave
        prog._spread_broadcasts(rng, n, m_wave, w_lo, w_hi + 4)
    for cols, names in ((adds, ("add_round", "add_p", "add_k", "add_q",
                                "add_delay")),
                        (rms, ("rm_round", "rm_p", "rm_k"))):
        cols = [np.concatenate(c) for c in cols]
        order = np.argsort(cols[0], kind="stable")
        for col, name in zip(cols, names):
            assert np.array_equal(col[order], getattr(scn, name)), name


@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_schedule_keeps_its_rules(seed):
    from repro_torch.core.vecsim.scenario import VecScenario
    spec = _spec(n=300, rate=6.0, messages=900, adds=16, removals=16)
    cfg, mix = spec.config, spec.traffic
    inp = build_inputs(cfg, mix, seed)
    again = build_inputs(cfg, mix, seed)
    assert all(np.array_equal(v, again[key]) for key, v in inp.items())
    k = cfg["k"]
    VecScenario(n=inp["n"], k=k, rounds=inp["rounds"], adj0=inp["adj0"],
                delay0=inp["delay0"], bcast_round=inp["bcast_round"],
                bcast_origin=inp["bcast_origin"],
                **{f: inp[f] for f in ("add_round", "add_p", "add_k",
                                       "add_q", "add_delay", "rm_round",
                                       "rm_p", "rm_k")}).validate()
    assert len(set(inp["add_p"].tolist())) == len(inp["add_p"])
    assert (inp["add_k"] == k - 1).all()
    assert ((inp["rm_k"] >= 1) & (inp["rm_k"] <= k - 2)).all()
    pairs = set(zip(inp["rm_p"].tolist(), inp["rm_k"].tolist()))
    assert len(pairs) == len(inp["rm_p"])
    last = int(inp["bcast_round"][-1])
    batches = np.unique(inp["add_round"] // mix["period"])
    assert list(batches) == list(range(1, len(batches) + 1))
    assert mix["period"] * len(batches) + mix["batch_rounds"] <= last
    assert mix["period"] * (len(batches) + 1) + mix["batch_rounds"] > last
    for rounds in (inp["add_round"], inp["rm_round"]):
        assert (rounds % mix["period"] < mix["batch_rounds"]).all()
    per = np.bincount(inp["add_round"] // mix["period"])[1:]
    assert (per == mix["adds"]).all()
    assert (np.bincount(inp["rm_round"] // mix["period"])[1:]
            <= mix["removals"]).all()
    assert inp["rounds"] > last
    assert (inp["adj0"][inp["add_p"], k - 1] == -1).all()
    assert not (inp["adj0"][inp["add_p"]] == inp["add_q"][:, None]).any()


def test_slots_of_the_sustained_overlay_are_kept():
    """Slots 0-7 of the churn cell's K=9 overlay are ``pc_kreg10k``'s
    K=8 overlay from the same seed, and slot 8 is free."""
    churn = load_cell(CELL).config
    static = load_cell("kreg10k.poisson").config
    build = load_file("gen/overlays", "kregular").build
    for seed in (1, BIG_SEED):
        a, da = build(dict(churn, n=500), seed)
        b, db = build(dict(static, n=500), seed)
        assert np.array_equal(a[:, :8], b) and (a[:, 8] == -1).all()
        assert np.array_equal(da[:, :8], db)
