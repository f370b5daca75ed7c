"""The yardstick's arithmetic on hand-made inputs: the operations and
bytes of a ``fused_sweep`` launch, the roofline share, and what the
harness reads from a device trace."""

from __future__ import annotations

import numpy as np
import torch

from causal_bench.harness.main import count_rooflines
from causal_bench.harness.readers import (Context, idle_share,
                                          launches_per_round, roofline_share)
from causal_bench.harness.spec import load_driver, load_roofline
from causal_bench.harness.trace import DeviceTrace, idle_by_label
from causal_bench.tests.small import small_spec

INF = 2 ** 30
PEAKS = {"hbm_bytes_per_s": 3.35e12, "core_ops_per_s": 6.7e13}


def _launch():
    """Round 5 on 4 processes x 8 columns, 2 out-slots: process 0
    broadcast column 0 this round, its copy arrives at process 1 now;
    both forward: 2 and 3 get an arrival at 6."""
    n, w, t = 4, 8, 5
    adj = torch.tensor([[1, 2], [2, 3], [3, 0], [0, 1]], dtype=torch.int32)
    crashed = torch.zeros(n, dtype=torch.bool)
    d_in = torch.full((n, w), -1, dtype=torch.int32)
    d_in[0, 0] = t
    a_in = torch.full((n, w), INF, dtype=torch.int32)
    a_in[1, 0] = t
    d_out, a_out = d_in.clone(), a_in.clone()
    d_out[1, 0] = t
    a_out[2, 0] = a_out[3, 0] = t + 1
    args = (a_out, d_out, crashed, adj, None, None, None, t)
    return args, (a_in, d_in < 0)


def test_fused_sweep_count_by_hand():
    mod = load_roofline("fused_sweep")
    args, snap = _launch()
    before = mod.before(torch, (snap[0], torch.where(snap[1], -1, 5)))
    assert torch.equal(before[0], snap[0]) and torch.equal(before[1], snap[1])
    nbytes, ops = (int(x) for x in mod.count(torch, args, snap))
    # delivered read 4*32, crash flags 4, column kinds 8, counters 8*4;
    # one changed delivered sector, 2 rows x 2 slots x 9 bytes of slot
    # table, two lowered arr sectors, four sectors of arr that decide a
    # cell
    assert nbytes == 128 + 4 + 8 + 32 + 32 + 36 + 64 + 128
    # 6 a cell, 3 a send over 2 slots of 2 cells delivered now
    assert ops == 6 * 32 + 3 * 2 * 2


def _trace(kernels):
    """A 10 ms window holding ``kernels``: (name, start ms, length ms)."""
    names = sorted({k[0] for k in kernels})
    return DeviceTrace(
        t0_ns=0, t1_ns=10_000_000, names=names,
        name_id=np.array([names.index(k[0]) for k in kernels], np.int32),
        start_ns=np.array([int(k[1] * 1e6) for k in kernels], np.int64),
        dur_ns=np.array([int(k[2] * 1e6) for k in kernels], np.int64),
        is_kernel=np.array([not k[0].startswith("Memcpy")
                            for k in kernels], bool))


PLANE = "void repro_torch::plane_kernel<true>(int const*)"
FORWARD = "repro_torch::forward_kernel(int*)"


def test_trace_busy_idle_and_labels():
    tr = _trace([(PLANE, 1, 2), (FORWARD, 2, 2), ("Memcpy HtoD", 6, 1)])
    assert tr.busy_s() == 0.004
    lo, hi = tr.gaps()
    assert list(zip(lo, hi)) == [(0, 1_000_000), (4_000_000, 6_000_000),
                                 (7_000_000, 10_000_000)]
    spans = [("outer", 0, 8_000_000), ("inner", 3_000_000, 6_500_000)]
    got = dict((k, round(v, 6)) for k, v in
               idle_by_label(tr, spans, "none"))
    assert got == {"outer": 0.001, "inner": 0.002, "none": 0.003}
    ctx = Context(setup_s=0, wall_s=0.01, reps=[],
                  trace=tr)
    assert abs(idle_share(ctx) - 60.0) < 1e-9
    assert tr.kernels() == 2


def test_roofline_share_scales_the_counted_repetition():
    mod = load_roofline("fused_sweep")
    # four launches in the trace, 1 ms of kernel time each
    tr = _trace([(PLANE, i * 2, 0.75) for i in range(4)]
                + [(FORWARD, i * 2 + 0.75, 0.25) for i in range(4)])
    ctx = Context(setup_s=0, wall_s=0.01, reps=[],
                  trace=tr, rooflines={"fused_sweep": (2, 0.0012)})
    # 0.6 ms of bound a launch over 1 ms of kernel a launch
    assert abs(roofline_share(ctx, "fused_sweep", mod) - 60.0) < 1e-9
    ctx.rooflines = {}
    assert roofline_share(ctx, "fused_sweep", mod) is None


def test_counted_repetition_on_the_cpu():
    """The harness's counting run wraps the program's wrapper: one count
    a round of the small cell, each bound positive, the wrapper put
    back."""
    from repro_torch.core.vecsim import kernels as kx
    before = kx.fused_sweep
    spec = small_spec("kreg10k.poisson")
    cell = load_driver(spec).Cell(spec, 4, "cpu")
    got = count_rooflines(torch, cell, ["fused_sweep"], PEAKS)
    launches, bound_s = got["fused_sweep"]
    assert launches == cell.scn.rounds
    assert bound_s > 0
    assert kx.fused_sweep is before
    ctx = Context(setup_s=0, wall_s=1.0, reps=[],
                  trace=_trace([(PLANE, 0, 1)]))
    assert launches_per_round(ctx) is None
