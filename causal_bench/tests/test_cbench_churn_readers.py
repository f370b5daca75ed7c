"""The churn cell's readers on hand-made inputs: the mean of the
``segment.blocked`` counter, the operations and bytes of a
``deliver_sweep`` and a ``frontier_sweep`` launch, and their roofline
shares over a synthetic device trace; the harness's counted repetition
of the small churn cell on the CPU, and its span readers on a traced
repetition there."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from causal_bench.drivers._judge import Rep
from causal_bench.harness.main import count_rooflines
from causal_bench.harness.readers import Context
from causal_bench.harness.spec import load_cell, load_driver, load_metric, \
    load_roofline
from causal_bench.harness.trace import DeviceTrace

INF = 2 ** 30
PEAKS = {"hbm_bytes_per_s": 3.35e12, "core_ops_per_s": 6.7e13}
DELIVER = "void repro_torch::deliver_kernel<true>(int const*, int*)"
FRONTIER = "repro_torch::frontier_kernel(repro_torch::FrontierArgs)"


def _rep(counters, program=True):
    out = {"counters": list(counters)} if program else {}
    return Rep(t0_ns=0, t1_ns=1, work={}, offered=0, rounds=8, out=out,
               spans=[("execute_windowed", 0, 1)])


def test_blocked_columns_is_the_mean_of_the_counter():
    reader = load_metric("blocked_columns.churn")
    reps = [_rep([("segment.activated", 50.0), ("segment.blocked", 4.0),
                  ("segment.retired", 3.0), ("segment.blocked", 0.0)]),
            _rep([("segment.blocked", 11.0)])]
    assert reader.read(Context(setup_s=0, wall_s=1, reps=reps)) == 5.0
    # the program before the counter: no value, not 0
    old = [_rep([("segment.activated", 50.0), ("segment.retired", 49.0)]),
           _rep([], program=False)]
    assert reader.read(Context(setup_s=0, wall_s=1, reps=old)) is None


def _deliver_launch():
    """Round 5 on 3 processes x 8 columns: process 1's copy of column 0
    arrives now and is delivered; process 2 is crashed."""
    n, w, t = 3, 8, 5
    arr = torch.full((n, w), INF, dtype=torch.int32)
    arr[1, 0] = t
    d_in = torch.full((n, w), -1, dtype=torch.int32)
    d_in[0, :] = 2
    crashed = torch.tensor([False, False, True])
    is_app = torch.ones(w, dtype=torch.bool)
    d_out = d_in.clone()
    d_out[1, 0] = t
    return (arr, d_in, crashed, is_app, t), d_out


def test_deliver_sweep_count_by_hand():
    mod = load_roofline("deliver_sweep")
    args, d_out = _deliver_launch()
    snap = mod.before(torch, args)
    assert torch.equal(snap, args[1] < 0)
    nbytes, ops = (int(x) for x in mod.count(
        torch, (args[0], d_out, *args[2:]), snap))
    # delivered read 4*24, crash flags 3, column kinds 8, counters 8*3;
    # one changed delivered sector; arr decides row 1 only: one sector
    assert nbytes == 96 + 3 + 8 + 24 + 32 + 32
    assert ops == 6 * 24


def _frontier_launch():
    """Round 7 on 4 processes x 8 columns, 2 slots.  Process 0 delivers
    column 0 now and forwards over slot 0 (to 1); process 2 flushes slot
    1 (gate 4, to 3), re-sending its app columns 1 and 2 delivered at 5
    and 6, not column 3, delivered at 3, before the gate."""
    n, w, t = 4, 8, 7
    adj = torch.tensor([[1, 2], [2, 3], [3, 0], [0, 1]], dtype=torch.int32)
    delay = torch.ones((n, 2), dtype=torch.int32)
    gate = torch.full((n, 2), -1, dtype=torch.int32)
    gate[2, 1] = 4
    do = torch.zeros((n, 2), dtype=torch.bool)
    do[2, 1] = True
    fwd = torch.zeros((n, 2), dtype=torch.bool)
    fwd[0, 0] = True
    is_app = torch.ones(w, dtype=torch.bool)
    d = torch.full((n, w), -1, dtype=torch.int32)
    d[0, 0] = t
    d[2, 1], d[2, 2], d[2, 3] = 5, 6, 3
    a_in = torch.full((n, w), INF, dtype=torch.int32)
    a_out = a_in.clone()
    a_out[1, 0] = a_out[3, 1] = a_out[3, 2] = t + 1
    return (a_out, d, adj, delay, gate, do, fwd, is_app, t), a_in


def test_frontier_sweep_count_by_hand():
    mod = load_roofline("frontier_sweep")
    args, a_in = _frontier_launch()
    snap = mod.before(torch, (a_in, *args[1:]))
    assert torch.equal(snap, a_in) and snap is not a_in
    nbytes, ops = (int(x) for x in mod.count(torch, args, snap))
    # delivered 4*32, column kinds 8, the count 8; every row holds an
    # undelivered app cell before t: 4 rows x 2 slots of do, 1 row x 2
    # of fwd_ok; one do slot's gate; 2 sending slots x (adj, delay);
    # two changed arr sectors read and written
    assert nbytes == 128 + 8 + 8 + 2 * 4 + 2 * 1 + 4 + 8 * 2 + 64 * 2
    # a compare a cell, 3 sends x 2
    assert ops == 32 + 2 * 3


def _trace(kernels):
    names = sorted({k[0] for k in kernels})
    return DeviceTrace(
        t0_ns=0, t1_ns=10_000_000, names=names,
        name_id=np.array([names.index(k[0]) for k in kernels], np.int32),
        start_ns=np.array([int(k[1] * 1e6) for k in kernels], np.int64),
        dur_ns=np.array([int(k[2] * 1e6) for k in kernels], np.int64),
        is_kernel=np.ones(len(kernels), bool))


@pytest.mark.parametrize("metric,kernel,name", [
    ("deliver_sweep_roofline.churn", "deliver_sweep", DELIVER),
    ("frontier_sweep_roofline.churn", "frontier_sweep", FRONTIER)])
def test_gated_roofline_share(metric, kernel, name):
    """Four launches of 0.5 ms each in the trace; the counted
    repetition's two launches had 0.6 ms of bound in all: 60%."""
    other = DELIVER if name == FRONTIER else FRONTIER
    tr = _trace([(name, i * 2, 0.5) for i in range(4)]
                + [(other, i * 2 + 1, 0.7) for i in range(4)])
    reader = load_metric(metric)
    assert reader.ROOFLINE == kernel
    ctx = Context(setup_s=0, wall_s=0.01, reps=[], trace=tr,
                  rooflines={kernel: (2, 0.0006)})
    assert reader.read(ctx) == pytest.approx(60.0, rel=1e-12)
    ctx.rooflines = {}
    assert reader.read(ctx) is None
    ctx = Context(setup_s=0, wall_s=0.01, reps=[], trace=_trace(
        [(other, 0, 1)]), rooflines={kernel: (2, 0.0006)})
    assert reader.read(ctx) is None


def test_counted_repetition_of_the_churn_cell_on_the_cpu():
    """The harness's counting run wraps both gated wrappers: one count a
    round each, every bound positive, the wrappers put back."""
    from repro_torch.core.vecsim import kernels as kx
    before = kx.deliver_sweep, kx.frontier_sweep
    spec = load_cell("kreg10k.churn")
    spec.config.update(n=120, window=256)
    spec.traffic.update(rate=4.0, messages=240, adds=6, removals=6,
                        period=24, batch_rounds=6)
    cell = load_driver(spec).Cell(spec, 2 ** 31 + 3, "cpu")
    got = count_rooflines(torch, cell, ["deliver_sweep", "frontier_sweep"],
                          PEAKS)
    for kernel in ("deliver_sweep", "frontier_sweep"):
        launches, bound_s = got[kernel]
        assert launches == cell.scn.rounds and bound_s > 0
    assert (kx.deliver_sweep, kx.frontier_sweep) == before


#: the churn cell's readers of the engine's spans and counters, and
#: the reader of the sustained cell that reads the same span, if any
SPAN_READERS = {
    "engine_setup_ms.churn": "engine_setup_ms.batch",
    "engine_finish_ms.churn": "engine_finish_ms.batch",
    "segment_dispatch_ms.churn": "segment_dispatch_ms.batch",
    "segment_enqueue_ms.churn": "segment_enqueue_ms.batch",
    "segment_wait_ms.churn": "segment_wait_ms.batch",
    "segment_retire_ms.churn": "segment_retire_ms.batch",
    "blocking_copies_per_round.churn": "blocking_copies_per_round.batch",
    "blocked_columns.churn": None,
}


@pytest.fixture(scope="module")
def traced_churn():
    spec = load_cell("kreg10k.churn")
    spec.config.update(n=120, window=256)
    spec.traffic.update(rate=4.0, messages=240, adds=6, removals=6,
                        period=24, batch_rounds=6)
    cell = load_driver(spec).Cell(spec, 2 ** 31 + 11, "cpu")
    reps = [cell.rep(spans=True), cell.rep(spans=True)]
    return (Context(setup_s=0, wall_s=1, reps=reps),
            Context(setup_s=0, wall_s=1, reps=[cell.rep()]))


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers_of_a_traced_churn_repetition(metric, traced_churn):
    """Each reads a positive number from a traced repetition, the one
    the sustained cell's reader of the same span reads, and nothing
    from an untraced one."""
    traced, untraced = traced_churn
    got = load_metric(metric).read(traced)
    assert got is not None and got > 0
    twin = SPAN_READERS[metric]
    if twin is not None:
        assert got == load_metric(twin).read(traced)
    assert load_metric(metric).read(untraced) is None
