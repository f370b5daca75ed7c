#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. build   — compile the CUDA kernels from ``csrc/`` (nvcc, sm_90a);
  2. kernels — each kernel against its plain PyTorch version on the card,
     byte for byte: small random inputs (odd and single-column windows,
     an all-retired window, a grid taller than 65,535 row blocks), the
     latency histogram on latencies that reach all 32 buckets and with
     more than 65,535 row chunks, then the inputs the main path gives
     each kernel, captured from short runs at the main-path shapes
     (N=10,000 x W=16,384 x K=8 sustained traffic; N=50,000 x W=140 x
     K=17 paper-scale churn; N=65,536 x W=1,024 serving), with the time
     of the bare kernel launch, of the wrapper around it, of the plain
     version, and the bound; fused_sweep also with the time of its plane
     pass alone (the deliver_sweep kernel on its inputs, no forward
     scatter);
  3. sustained — the sustained-traffic configuration (N=10,000, k-regular
     K=8, Poisson 1,000 broadcasts a round, 1,000,000 broadcasts, window
     16,384, seg_len 8) through ``repro_torch.api.run``: full delivery,
     the window held, one fused_sweep launch a round, one retire_reduce
     launch a retirement sweep and one latency_hist launch a sweep that
     retired app columns;
  4. gated — the paper-scale Fig. 7 churn run (N=50,000, ring K=17, 12
     broadcasts, 128 link additions and removals in 16 rounds, delay 3,
     snapshot at the last churn round, oracle on): full delivery, a
     clean oracle, deliver_sweep and frontier_sweep launched every round;
  5. parity — a sustained N=2,048 windowed run and an N=1,024 churn run
     on the card and on the CPU (plain versions): byte-identical;
  6. serve — the live serving front door at the headline configuration
     of BENCH_serve.json (N=65,536, k-regular K=4, bursty arrivals at 64
     a round over a base of 16, 200,000 submissions, defer admission,
     window 1,024, seg_len 16) on the windowed engine, with histograms,
     spans, 1-in-1,024 provenance, the causality audit in fail mode, and
     the metrics, trace and ops files: every submission admitted and
     delivered, the histogram total equal to the deliveries, no audit
     violation, one fused_sweep launch a round, one retire_reduce launch
     a retirement sweep, one latency_hist launch a sweep that retired
     app columns, and the three files loaded back;
  7. live parity — two N=1,024 live runs (bursty/defer, and admit with
     window overflows) on the card and on the CPU, with the full
     delivered matrix, the oracle, provenance of every message and the
     audit in fail mode: report, series, histogram, provenance and ops
     records byte-identical.

Then the kernels line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KSRC = "src/repro_torch/core/vecsim/kernels/csrc"
TPU_KERNELS = "src/repro/core/vecsim/kernels/kernel.py"
# H100 SXM data-sheet peaks: HBM bandwidth, and the CUDA-core 32-bit rate
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

SUSTAINED_MESSAGES = 1_000_000
SERVE_MESSAGES = 200_000


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.backend import resolve_device
    from repro_torch.core.vecsim.kernels import _build

    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ------------------------------------------------------ #
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0, library=str(
        lib_path.relative_to(ROOT)), ptxas=[
        line.strip() for line in log
        if "registers" in line or "spill" in line])

    # -- 2. kernels against their plain versions ---------------------- #
    check_small(torch, np, dev)
    entries = check_main_path(torch)

    # -- 3. sustained main path --------------------------------------- #
    # each main-path phase returns the launches of the kernels it drives
    # and those of retire_scan, which no engine calls (summed, 0)
    launches, scans = {}, []
    launches.update(sustained_phase(torch))
    scans.append(launches.pop("retire_scan"))
    # -- 4. gated main path ------------------------------------------- #
    launches.update(gated_phase(torch))
    scans.append(launches.pop("retire_scan"))
    # -- 5. whole-engine parity, card vs CPU --------------------------- #
    parity_phase(np)
    # -- 6. the live serving path -------------------------------------- #
    launches.update(serve_phase(torch, np))
    scans.append(launches.pop("retire_scan"))
    # -- 7. live parity, card vs CPU ----------------------------------- #
    live_parity_phase(np)
    launches["retire_scan"] = sum(scans)

    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --------------------------------------------------------------------- #
# Phase 2: kernels
# --------------------------------------------------------------------- #
INF = 2 ** 30


def _random_inputs(torch, np, rng, n, w, k, dev):
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    ncols = max(1, w // 2)
    return dict(
        base=t(np.where(rng.random(ncols) < 0.8, rng.integers(0, 10, ncols),
                        -1), torch.int32),
        cols=torch.from_numpy(rng.permutation(w)[:ncols].astype(np.int64)),
        t=int(rng.integers(1, 20)),
        arr=t(np.where(rng.random((n, w)) < 0.4, rng.integers(0, 25, (n, w)),
                       INF), torch.int32),
        delivered=t(np.where(rng.random((n, w)) < 0.4,
                             rng.integers(0, 20, (n, w)), -1), torch.int32),
        crashed=t(rng.random(n) < 0.2, torch.bool),
        is_app=t(rng.random(w) < 0.7, torch.bool),
        adj=t(rng.integers(0, n, (n, k)), torch.int32),
        delay=t(rng.integers(1, 4, (n, k)), torch.int32),
        gate=t(np.where(rng.random((n, k)) < 0.3, rng.integers(0, 15, (n, k)),
                        -1), torch.int32),
        do=t(rng.random((n, k)) < 0.3, torch.bool),
        fwd_ok=t(rng.random((n, k)) < 0.6, torch.bool),
        min_gate=t(np.where(rng.random(n) < 0.3, rng.integers(0, 15, n), INF),
                   torch.int32),
        rounds=22)


def _ops():
    """name -> (kernel wrapper, plain version, argument names, names of
    the arguments the kernel updates in place, bare launch, maker of the
    outputs the bare launch writes)."""
    import torch
    from repro_torch.core.vecsim.kernels import ops, ref

    def zeros(*shapes_dtypes):
        def make(inp):
            dev = inp["arr"].device
            n, w = inp["arr"].shape
            size = {"n": n, "w": w, "": ()}
            return [torch.zeros(size[s], dtype=dt, device=dev)
                    for s, dt in shapes_dtypes]
        return make

    counts = zeros(("n", torch.int32), ("n", torch.int32))

    def hist_out(inp):
        # the output, and the card's copy of the host's column indices
        dev = inp["base"].device
        return [torch.zeros((inp["base"].shape[0], ref.NB),
                            dtype=torch.int32, device=dev),
                inp["cols"].to(dev)]

    def launch_hist(base, delivered, cols, hist, cols_dev):
        ops.launch_latency_hist(base, delivered, cols_dev, hist)

    def scan_out(inp):
        w = inp["delivered"].shape[1]
        return [torch.zeros(w, dtype=torch.int32,
                            device=inp["delivered"].device)
                for _ in range(3)]

    return {
        "fused_sweep": (ops.fused_sweep, ref.fused_sweep_ref,
                        ("arr", "delivered", "crashed", "adj", "delay",
                         "fwd_ok", "is_app", "t"), ("arr", "delivered"),
                        ops.launch_fused_sweep, counts),
        "deliver_sweep": (ops.deliver_sweep, ref.deliver_sweep_ref,
                          ("arr", "delivered", "crashed", "is_app", "t"),
                          ("delivered",), ops.launch_deliver_sweep, counts),
        "frontier_sweep": (ops.frontier_sweep, ref.frontier_sweep_ref,
                           ("arr", "delivered", "adj", "delay", "gate", "do",
                            "fwd_ok", "is_app", "t"), ("arr",),
                           ops.launch_frontier_sweep,
                           zeros(("", torch.int64))),
        "retire_reduce": (ops.retire_reduce, ref.retire_reduce_ref,
                          ("arr", "delivered", "crashed", "min_gate",
                           "rounds"), (), ops.launch_retire_reduce,
                          zeros(*[("w", torch.int32)] * 4,
                                ("w", torch.int64))),
        "retire_scan": (ops.retire_scan, ref.retire_scan_ref,
                        ("delivered", "crashed", "min_gate"), (),
                        ops.launch_retire_scan, scan_out),
        "latency_hist": (ops.latency_hist, ref.latency_hist_ref,
                         ("base", "delivered", "cols"), (),
                         launch_hist, hist_out),
    }


def _call(torch, fn, names, inputs, inplace):
    """Call ``fn`` on fresh copies of the arguments it writes."""
    args = [inputs[k].clone() if k in inplace else inputs[k] for k in names]
    return fn(*args)


def _max_err(torch, got, want) -> int:
    """Largest |difference| over the outputs (a tensor or a tuple)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), (len(got), len(want))
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    return err


def _time_ms(torch, fn, names, inputs, inplace, reps, make_outs=None):
    """Median CUDA-event time of one call of ``fn``.  The copies of the
    in-place arguments, and the outputs ``make_outs`` allocates for a
    bare launch, are made outside the timed interval.  The L2 cache is
    not flushed: the planes the churn-shape kernels get (28 MB each) sit
    partly in the 50 MB L2 on the path too, as the sweep before them
    has just touched them."""
    pairs = []
    for _ in range(reps):
        args = [inputs[k].clone() if k in inplace else inputs[k]
                for k in names]
        if make_outs is not None:
            args += make_outs(inputs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _sectors(torch, mask) -> int:
    """The 32-byte sectors (8 cells) of an int32 plane that hold a cell
    of ``mask``: the least the memory moves to touch those cells (a
    CUDA allocation starts on a 256-byte boundary)."""
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, 8).any(dim=1).sum())


def _bound(torch, name, inp, plain_out):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move over the card's memory rate and its integer operations over the
    card's CUDA-core rate, counted from these inputs.  Bytes: each plane
    cell the output depends on is read once, each changed cell written
    once, both counted in whole 32-byte sectors; the (N, K) tables only
    for rows that use them."""
    n, w = inp["delivered"].shape
    cells = n * w
    k = inp["adj"].shape[1] if "adj" in inp else 0
    d, t = inp["delivered"], inp.get("t")
    if name in ("fused_sweep", "deliver_sweep"):
        # arr decides a cell only while it is undelivered on a live row
        need_arr = (d < 0) & ~inp["crashed"][:, None]
        d_out = plain_out[-3]
        d_changed = d_out != d
        nbytes = 4 * cells + n + w + 8 * n + 32 * _sectors(torch, d_changed)
        ops = 6 * cells
        if name == "fused_sweep":
            # the scatter reads and writes the cells it lowers
            a_changed = plain_out[0] != inp["arr"]
            need_arr |= a_changed
            now = d_out == t
            rows_now = int(now.any(dim=1).sum())
            nbytes += 9 * k * rows_now + 32 * _sectors(torch, a_changed)
            ops += 3 * k * int(now.sum())
        nbytes += 32 * _sectors(torch, need_arr)
    elif name == "frontier_sweep":
        active = (d == t) | ((d < t) & inp["is_app"][None, :])
        rows_active = int(active.any(dim=1).sum())
        a_changed = plain_out[0] != inp["arr"]
        nbytes = (4 * cells + w + 14 * k * rows_active + 8
                  + 64 * _sectors(torch, a_changed))
        ops = 3 * cells + 5 * k * int(active.sum())
    elif name == "retire_scan":
        # every cell of delivered counts in some output
        nbytes = 4 * cells + 5 * n + 12 * w
        ops = 5 * cells
    elif name == "latency_hist":
        # the selected columns' cells, in whole sectors, then the
        # (C,) bases and indices and the (C, 32) counters
        c = inp["base"].shape[0]
        sel = torch.zeros((n, w), dtype=torch.bool, device=d.device)
        sel[:, inp["cols"].to(d.device)] = True
        nbytes = 32 * _sectors(torch, sel) + 12 * c + 128 * c
        ops = 8 * n * c
    else:
        # every cell of both planes counts in some output
        nbytes = 8 * cells + 5 * n + 24 * w
        ops = 8 * cells
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _capture(torch, calls, wanted):
    """Patch the kernel wrappers the engines call so that the arguments
    of call number ``wanted[name]`` of each are kept (cloned); returns
    the store and an undo function."""
    from repro_torch.core.vecsim import kernels as kx
    store, seen, saved = {}, {}, {}
    for name, (_, _, names, *_) in calls.items():
        if name not in wanted:
            continue
        orig = getattr(kx, name)
        saved[name] = orig

        def rec(*args, _name=name, _names=names, _orig=orig):
            seen[_name] = seen.get(_name, 0) + 1
            if seen[_name] == wanted[_name]:
                store[_name] = {
                    key: (a.clone() if isinstance(a, torch.Tensor) else a)
                    for key, a in zip(_names, args)}
            return _orig(*args)
        setattr(kx, name, rec)

    def undo():
        for name, orig in saved.items():
            setattr(kx, name, orig)
    return store, undo


def check_small(torch, np, dev):
    """Every kernel against its plain version on small random inputs."""
    calls = _ops()
    # small random inputs: odd windows, ragged tiles, one column, a tall
    # grid (more than 65,535 row blocks), and an all-retired window
    rng = np.random.default_rng(20260)
    shapes = [(16, 9, 3), (24, 7, 4), (8, 1, 2), (12, 11, 3), (100, 77, 5),
              (600_000, 3, 2)]
    cases = [_random_inputs(torch, np, rng, n, w, k, dev)
             for n, w, k in shapes]
    retired = _random_inputs(torch, np, rng, 10, 6, 3, dev)
    retired["arr"].fill_(INF)
    retired["delivered"].fill_(-1)
    cases.append(retired)
    for inp in cases:
        for name, (kernel, plain, names, inplace, *_) in calls.items():
            got = _call(torch, kernel, names, inp, inplace)
            want = plain(*[inp[k] for k in names])
            err = _max_err(torch, got, want)
            if err:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version on {tuple(inp['arr'].shape)}"
                                     f": max |err| {err}")
    torch.cuda.synchronize()
    emit("kernels_small", cases=len(cases), kernels=sorted(calls),
         max_abs_err=0)
    check_hist_buckets(torch, np, dev)


def check_hist_buckets(torch, np, dev):
    """latency_hist against its plain version on latencies that reach
    all 32 buckets (each bucket's lower bound, its last value and a value
    inside it; rows that never delivered, columns with no base), on the
    whole plane and on a column subset, for single, odd and wider
    column counts; then with more row chunks (75,000) than a grid has
    rows, the wrapper's block target raised for one call so that a chunk
    is 8 rows; and a column index outside the plane refused on the card
    as on the CPU."""
    from repro_torch.core.vecsim.kernels import ops, ref
    rng = np.random.default_rng(20261)
    lo = np.array([b if b < 16 else 1 << (b - 12) for b in range(ref.NB)],
                  np.int64)
    hi = np.append(lo[1:] - 1, 2 ** 29)

    def inputs(n, w):
        pick = rng.integers(0, ref.NB, (n, w))
        where = rng.integers(0, 3, (n, w))
        lat = np.where(where == 0, lo[pick], np.where(
            where == 1, hi[pick], (lo[pick] + hi[pick]) // 2))
        base = rng.integers(0, 50, w)
        base[rng.random(w) < 0.2] = -1
        d = np.where(base[None, :] >= 0, base[None, :] + lat, lat)
        d[rng.random((n, w)) < 0.25] = -1
        return (torch.from_numpy(base.astype(np.int32)).to(dev),
                torch.from_numpy(d.astype(np.int32)).to(dev))

    buckets = torch.zeros(ref.NB, dtype=torch.int64, device=dev)
    for n, w in ((500, 1), (500, 5), (500, 37), (1000, 300)):
        base, d = inputs(n, w)
        want = ref.latency_hist_ref(base, d)
        got = ops.latency_hist(base, d)
        cols = torch.from_numpy(
            rng.permutation(w)[: max(1, w // 3)].astype(np.int64))
        sub = ops.latency_hist(base[cols.to(dev)], d, cols)
        if not (torch.equal(got, want)
                and torch.equal(sub, want[cols.to(dev)])):
            raise AssertionError(f"latency_hist differs from its plain "
                                 f"version on ({n}, {w})")
        buckets += want.sum(dim=0)
    if not bool((buckets > 0).all()):
        raise AssertionError("the bucket check missed a bucket")
    base, d = inputs(600_000, 3)
    target = ops._HIST_TARGET_BLOCKS
    ops._HIST_TARGET_BLOCKS = 75_000
    try:
        chunk_rows = ops._hist_rows_per_chunk(600_000, 3)
        got = ops.latency_hist(base, d)
    finally:
        ops._HIST_TARGET_BLOCKS = target
    assert chunk_rows == 8, chunk_rows
    if not torch.equal(got, ref.latency_hist_ref(base, d)):
        raise AssertionError("latency_hist differs from its plain version "
                             "with 75,000 row chunks")
    for bad in (-1, 3):
        cols = torch.tensor([0, bad], dtype=torch.int64)
        for plane in (d, d.cpu()):
            try:
                ops.latency_hist(base[:2].to(plane.device), plane, cols)
            except IndexError:
                continue
            raise AssertionError(f"latency_hist took column {bad} of 3 "
                                 f"on {plane.device}")
    torch.cuda.synchronize()
    emit("kernels_hist_buckets", cases=5, buckets_reached=ref.NB,
         row_chunks=75_000, out_of_range_refused=True, max_abs_err=0)


def check_main_path(torch):
    """Every kernel against its plain version on the inputs the main
    path gives it, captured from short runs at the main-path shapes,
    with its time, its plain version's time and its bound."""
    calls = _ops()
    from repro_torch.api import build_scenario, run
    store, undo = _capture(torch, calls, {"fused_sweep": 33,
                                          "retire_reduce": 4})
    try:
        run(sustained_spec(messages=40_000))
    finally:
        undo()
    gated = gated_spec()
    t_cap = int(build_scenario(gated).add_round[-1])
    store2, undo = _capture(torch, calls, {"deliver_sweep": t_cap + 1,
                                           "frontier_sweep": t_cap + 1})
    try:
        run(gated)
    finally:
        undo()
    store.update(store2)
    # the serving shape, from the spike of a shorter serving run
    store3, undo = _capture(torch, calls, {"latency_hist": 16})
    try:
        run(serve_spec(messages=20_000))
    finally:
        undo()
    store.update(store3)
    # retire_scan on retire_reduce's inputs (no engine calls it)
    store["retire_scan"] = store["retire_reduce"]

    entries = []
    for name, (kernel, plain, names, inplace, launch, outs) in calls.items():
        inp = store[name]
        got = _call(torch, kernel, names, inp, inplace)
        want = plain(*[inp[k] for k in names])
        err = _max_err(torch, got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at the main-path shape: max |err| {err}")
        bound_ms, bound_by = _bound(torch, name, inp, want)
        ms = _time_ms(torch, launch, names, inp, inplace, 20, outs)
        wrapper_ms = _time_ms(torch, kernel, names, inp, inplace, 20)
        plain_ms = _time_ms(torch, plain, names, inp, (), 5)
        ms2 = _time_ms(torch, launch, names, inp, inplace, 20, outs)
        entry = dict(
            name=name, route="cuda", source=f"{KSRC}/{SOURCES[name]}",
            replaces=f"{TPU_KERNELS}:{TPU_LINES[name]}", launches=None,
            max_abs_err=err, ms=min(ms, ms2), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape=list(inp["delivered"].shape),
            k=(inp["adj"].shape[1] if "adj" in inp else None),
            ms_repeats=[ms, ms2], wrapper_ms=wrapper_ms)
        if name == "latency_hist":
            entry["cols"] = int(inp["cols"].shape[0])
        if name == "fused_sweep":
            # the same plane pass without the forward scatter: the
            # deliver_sweep kernel on fused_sweep's inputs
            _, _, dnames, dinplace, dlaunch, douts = calls["deliver_sweep"]
            entry["plane_pass_ms"] = _time_ms(torch, dlaunch, dnames, inp,
                                              dinplace, 20, douts)
        emit("kernel", **entry)
        entries.append(entry)
        del inp, got, want
    store.clear()
    torch.cuda.empty_cache()
    return entries


TPU_LINES = {"fused_sweep": 121, "deliver_sweep": 75, "frontier_sweep": 139,
             "retire_reduce": 178, "retire_scan": 161, "latency_hist": 203}
SOURCES = {"fused_sweep": "fused_sweep.cu",
           "deliver_sweep": "deliver_sweep.cu",
           "frontier_sweep": "frontier_sweep.cu",
           "retire_reduce": "retire_reduce.cu",
           # retire_scan is retire_reduce.cu with its record outputs off
           "retire_scan": "retire_reduce.cu",
           "latency_hist": "latency_hist.cu"}


# --------------------------------------------------------------------- #
# Phases 3-5: the main path
# --------------------------------------------------------------------- #
def sustained_spec(messages: int, n: int = 10_000, rate: float = 1000.0,
                   window: int = 16_384, collect: str = "aggregate",
                   device=None):
    """The headline sustained-throughput configuration of
    BENCH_throughput.json (N=10,000, k-regular K=8, Poisson traffic,
    window 16,384, seg_len 8, max_delay 1)."""
    from repro_torch.api import RunSpec, TopologySpec, TrafficSpec, WindowSpec
    return RunSpec(
        protocol="pc", engine="windowed", n=n, seed=0, device=device,
        topology=TopologySpec(kind="kregular", k=8, max_delay=1),
        traffic=TrafficSpec(kind="poisson", rate=rate, messages=messages),
        window=WindowSpec(window=window, seg_len=8, collect=collect))


def gated_spec(n: int = 50_000, k: int = 17, device=None, oracle=False):
    """The paper-scale Fig. 7 churn configuration of
    benchmarks/bench_fig7.py (rows_vec, delay 3)."""
    from repro_torch.api import (DynamicsSpec, MetricsSpec, RunSpec,
                                 TopologySpec, TrafficSpec)
    delay = 3
    return RunSpec(
        protocol="pc", engine="vec", n=n, seed=3 + delay, device=device,
        topology=TopologySpec(kind="ring", k=k, max_delay=delay),
        traffic=TrafficSpec(kind="uniform", messages=12),
        dynamics=DynamicsSpec(kind="churn", n_adds=128, n_rms=128,
                              churn_window=16),
        metrics=MetricsSpec(snapshot="last_churn", oracle=oracle))


def serve_spec(messages: int, n: int = 65_536, window: int = 1024,
               obs=None, device=None):
    """The headline serving configuration of BENCH_serve.json and
    benchmarks/bench_serve.py (N=65,536, k-regular K=4, max_delay 1,
    bursty arrivals at 64 a round over a base of 16 with one
    311-round spike, defer admission, queue 65,536, window 1,024,
    seg_len 16, p99 SLO 640 rounds), on the windowed engine."""
    from repro_torch.api import (LiveSpec, ObsSpec, RunSpec, TopologySpec,
                                 WindowSpec)
    return RunSpec(
        protocol="pc", mode="live", engine="windowed", n=n, seed=0,
        device=device,
        topology=TopologySpec(kind="kregular", k=4, max_delay=1),
        window=WindowSpec(window=window, seg_len=16, collect="aggregate"),
        live=LiveSpec(arrivals="bursty", admission="defer", rate=64.0,
                      rate_lo=16.0, period=16_384, duty=0.019,
                      messages=messages, queue_cap=65_536, slo_p99=640.0),
        obs=obs or ObsSpec())


def sustained_phase(torch):
    from repro_torch.api import build_scenario, run
    from repro_torch.core.vecsim import kernels as kx
    spec = sustained_spec(SUSTAINED_MESSAGES)
    t0 = time.perf_counter()
    build_scenario(spec)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kx.reset_launches()
    t0 = time.perf_counter()
    rep = run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kx.LAUNCHES)
    res = rep.result
    assert rep.engine == "windowed" and rep.window == 16_384
    assert rep.delivered_frac == 1.0, rep.delivered_frac
    assert res.peak_live <= 16_384, res.peak_live
    assert launches["fused_sweep"] == rep.rounds, (launches, rep.rounds)
    assert launches["retire_reduce"] == res.sweeps, (launches, res.sweeps)
    assert launches["latency_hist"] == res.app_sweeps > 0, (
        launches, res.app_sweeps)
    assert rep.extras["latency_hist_total"] == int(
        res.deliv_count[: rep.m_app].sum())
    assert launches["deliver_sweep"] == launches["frontier_sweep"] == 0
    assert launches["retire_scan"] == 0, launches
    sends = rep.stats.sent_messages
    emit("sustained", n=rep.n, messages=rep.m_app, rounds=rep.rounds,
         segments=res.segments, retire_sweeps=res.sweeps,
         scenario_build_seconds=build_s, run_wall_seconds=wall,
         engine_wall_seconds=rep.wall_seconds, sends=sends,
         sends_per_sec=sends / rep.wall_seconds,
         broadcasts_per_sec=rep.m_app / rep.wall_seconds,
         deliveries=rep.stats.deliveries,
         delivered_frac=rep.delivered_frac,
         mean_latency_rounds=rep.mean_latency, peak_live=res.peak_live,
         latency_p50=rep.extras["latency_p50"],
         latency_p99=rep.extras["latency_p99"],
         latency_p999=rep.extras["latency_p999"],
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={k: launches[k] for k in ("fused_sweep", "retire_reduce",
                                            "latency_hist", "retire_scan")})
    return {k: launches[k] for k in ("fused_sweep", "retire_reduce",
                                     "retire_scan")}


def gated_phase(torch):
    from repro_torch.api import run
    from repro_torch.core.vecsim import kernels as kx
    spec = gated_spec(oracle=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kx.reset_launches()
    t0 = time.perf_counter()
    rep = run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kx.LAUNCHES)
    assert rep.engine == "vec"
    assert rep.delivered_frac == 1.0, rep.delivered_frac
    assert rep.oracle.ok, rep.oracle.summary()
    assert rep.result.snapshot is not None
    assert launches["deliver_sweep"] == rep.rounds, (launches, rep.rounds)
    assert launches["frontier_sweep"] == rep.rounds, (launches, rep.rounds)
    assert launches["fused_sweep"] == launches["retire_reduce"] == 0
    assert launches["retire_scan"] == 0, launches
    emit("gated", n=rep.n, k=spec.topology.k, messages=rep.m_app,
         adds=rep.scenario.n_adds, rounds=rep.rounds,
         run_wall_seconds=wall, engine_wall_seconds=rep.wall_seconds,
         delivered_frac=rep.delivered_frac,
         mean_latency_rounds=rep.mean_latency,
         pongs=rep.extras["pongs"],
         gated_link_rounds=rep.extras["gated_link_rounds"],
         oracle=rep.oracle.summary(),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={k: launches[k] for k in ("deliver_sweep",
                                            "frontier_sweep", "retire_scan")})
    return {k: launches[k] for k in ("deliver_sweep", "frontier_sweep",
                                     "retire_scan")}


def serve_phase(torch, np):
    """The serving path at the headline configuration, with every
    telemetry pillar on; returns the launches of its one kernel that no
    other phase drives (latency_hist) and of retire_scan (0)."""
    import tempfile

    from repro_torch.api import ObsSpec, run
    from repro_torch.core.vecsim import kernels as kx
    from repro_torch.obs import load_metrics_jsonl, load_ops_jsonl
    with tempfile.TemporaryDirectory() as tmp:
        paths = {key: os.path.join(tmp, name) for key, name in (
            ("metrics", "serve.metrics.jsonl"), ("trace", "serve.trace.json"),
            ("ops", "serve.ops.jsonl"))}
        spec = serve_spec(SERVE_MESSAGES, obs=ObsSpec(
            spans=True, provenance=1024, sampler="hash", audit="fail",
            metrics_out=paths["metrics"], trace_out=paths["trace"],
            ops_out=paths["ops"], ops_sink="jsonl", ops_every=16))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kx.reset_launches()
        t0 = time.perf_counter()
        rep = run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kx.LAUNCHES)
        lr, res, ex = rep.live, rep.result, rep.extras
        assert rep.engine == "windowed" and rep.window == spec.window.window
        assert rep.device.startswith("cuda")
        assert (lr.admitted + lr.shed_queue + lr.shed_policy + lr.unserved
                == lr.offered == SERVE_MESSAGES), lr.to_dict()
        assert lr.unserved == 0 and lr.delivered_frac == 1.0, lr.to_dict()
        assert ex["latency_hist_total"] == int(
            res.deliv_count[: rep.m_app].sum()) > 0
        assert ex["audit_violations"] == 0 and ex["audit_pairs_checked"] > 0
        assert launches["fused_sweep"] == lr.rounds, (launches, lr.rounds)
        assert launches["retire_reduce"] == res.sweeps, (launches,
                                                         res.sweeps)
        assert launches["latency_hist"] == res.app_sweeps > 0, (
            launches, res.app_sweeps)
        assert launches["deliver_sweep"] == launches["frontier_sweep"] == 0
        assert launches["retire_scan"] == 0, launches
        doc = load_metrics_jsonl(paths["metrics"])
        assert int(doc["latency_hist"].sum()) == ex["latency_hist_total"]
        assert len(doc["provenance"]) == ex["provenance_sampled"]
        with open(paths["trace"]) as fh:
            trace = json.load(fh)["traceEvents"]
        ticks = load_ops_jsonl(paths["ops"])
        assert ticks and ticks[-1]["admitted_total"] == lr.admitted
    span_ms = {}
    for ev in rep.obs.spans.events():
        if ev["kind"] == "span":
            span_ms[ev["name"]] = span_ms.get(ev["name"], 0.0) + \
                ev["dur_ns"] / 1e6
    emit("serve", n=rep.n, window=rep.window, seg_len=16,
         offered=lr.offered, admitted=lr.admitted, shed=lr.shed_queue
         + lr.shed_policy, unserved=lr.unserved, rounds=lr.rounds,
         ticks=lr.ticks_run, segments=res.segments, retire_sweeps=res.sweeps,
         engine_wall_seconds=lr.wall_seconds, run_wall_seconds=wall,
         requests_per_sec=lr.requests_per_sec, p50=lr.p50, p99=lr.p99,
         p999=lr.p999, mean_latency_rounds=lr.mean_latency_rounds,
         slo_ok=lr.slo_ok, queue_peak=lr.queue_peak,
         backpressure_ticks=lr.backpressure_ticks,
         overflow_catches=lr.overflow_catches, peak_live=lr.peak_live,
         delivered_frac=lr.delivered_frac,
         latency_hist_total=ex["latency_hist_total"],
         provenance_sampled=ex["provenance_sampled"],
         audit_pairs_checked=ex["audit_pairs_checked"],
         audit_violations=ex["audit_violations"],
         trace_events=len(trace), ops_records=len(ticks),
         span_host_ms=span_ms, spans_dropped=rep.obs.spans.dropped,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={k: launches[k] for k in ("fused_sweep", "retire_reduce",
                                            "latency_hist", "retire_scan")})
    return {k: launches[k] for k in ("latency_hist", "retire_scan")}


def live_parity_phase(np):
    """Two N=1,024 live runs on the card and on the CPU, byte for byte:
    the report, the per-tick records, the series, the delivered matrix,
    the histogram, the provenance and the ops records."""
    import tempfile

    from repro_torch.api import ObsSpec, run
    from repro_torch.obs import load_ops_jsonl
    cases = {"bursty_defer_n1024": dict(admission="defer", window=48),
             "admit_overflow_n1024": dict(admission="admit", window=32)}
    for name, case in cases.items():
        t0 = time.perf_counter()
        reps, ops = [], []
        with tempfile.TemporaryDirectory() as tmp:
            for device in (None, "cpu"):
                path = os.path.join(tmp, f"ops.{device}.jsonl")
                spec = parity_live_spec(case, device, path)
                reps.append(run(spec))
                ops.append(load_ops_jsonl(path))
        gpu, cpu = reps
        a, b = gpu.result, cpu.result
        assert gpu.device.startswith("cuda") and cpu.device == "cpu"
        da, db = gpu.live.to_dict(), cpu.live.to_dict()
        for key in ("wall_seconds", "requests_per_sec"):
            da.pop(key)
            db.pop(key)
        assert da == db, name
        assert gpu.live.ticks == cpu.live.ticks, name
        assert gpu.oracle.ok and cpu.oracle.ok, name
        assert a.stats == b.stats, name
        for key in ("delivered", "series", "deliv_count", "deliv_round_sum",
                    "bcast_done", "expired"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                          f"{name}/{key}")
        np.testing.assert_array_equal(gpu.obs.latency_hist,
                                      cpu.obs.latency_hist, name)
        assert gpu.obs.flight.export() == cpu.obs.flight.export(), name
        assert ops[0] == ops[1] and ops[0], name
        drop = ("serve_requests_per_sec",)
        assert ({k: v for k, v in gpu.extras.items() if k not in drop}
                == {k: v for k, v in cpu.extras.items() if k not in drop})
        if case["admission"] == "admit":
            assert gpu.live.overflow_catches > 0, name
        else:
            assert gpu.live.backpressure_ticks > 0, name
        emit("live_parity", case=name, rounds=gpu.rounds,
             ticks=gpu.live.ticks_run,
             overflow_catches=gpu.live.overflow_catches,
             backpressure_ticks=gpu.live.backpressure_ticks,
             provenance_records=len(gpu.obs.flight.completed),
             audit_pairs_checked=gpu.extras["audit_pairs_checked"],
             identical=True, seconds=time.perf_counter() - t0)


def parity_live_spec(case, device, ops_out):
    from repro_torch.api import (LiveSpec, MetricsSpec, ObsSpec, RunSpec,
                                 TopologySpec, WindowSpec)
    return RunSpec(
        protocol="pc", mode="live", engine="windowed", n=1024, seed=4,
        device=device,
        topology=TopologySpec(kind="kregular", k=4, max_delay=1),
        window=WindowSpec(window=case["window"], seg_len=8, collect="full"),
        live=LiveSpec(arrivals="bursty", admission=case["admission"],
                      rate=16.0, period=64, duty=0.5, messages=120,
                      queue_cap=4096),
        metrics=MetricsSpec(oracle=True),
        obs=ObsSpec(provenance=1, sampler="all", audit="fail",
                    ops_out=ops_out, ops_sink="jsonl", ops_every=2))


def parity_phase(np):
    from repro_torch.api import run
    specs = {
        "sustained_n2048": lambda d: sustained_spec(
            messages=4096, n=2048, rate=64.0, window=2048, collect="full",
            device=d),
        "churn_n1024": lambda d: gated_spec(n=1024, k=6, device=d),
    }
    for name, make in specs.items():
        t0 = time.perf_counter()
        gpu, cpu = run(make(None)), run(make("cpu"))
        a, b = gpu.result, cpu.result
        assert gpu.device.startswith("cuda") and cpu.device == "cpu"
        assert a.stats == b.stats, name
        np.testing.assert_array_equal(a.delivered, b.delivered, name)
        np.testing.assert_array_equal(a.series, b.series, name)
        for key in a.state:
            np.testing.assert_array_equal(a.state[key], b.state[key],
                                          f"{name}/{key}")
        if a.snapshot is not None:
            for key in a.snapshot:
                np.testing.assert_array_equal(a.snapshot[key],
                                              b.snapshot[key],
                                              f"{name}/snapshot/{key}")
        assert gpu.extras == cpu.extras, name
        emit("parity", case=name, rounds=gpu.rounds, engine=gpu.engine,
             identical=True, seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    sys.exit(main())
