#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. build   — compile the CUDA kernels from ``csrc/`` (nvcc, sm_90a);
  2. kernels — each kernel against its plain PyTorch version on the card,
     byte for byte: small random inputs (odd and single-column windows,
     an all-retired window, a grid taller than 65,535 row blocks), then
     the inputs the main path gives it, captured from short runs at the
     main-path shapes (N=10,000 x W=16,384 x K=8 sustained traffic;
     N=50,000 x W=140 x K=17 paper-scale churn), with the time of the
     bare kernel launch, of the wrapper around it, of the plain version,
     and the bound; fused_sweep also with the time of its plane pass
     alone (the deliver_sweep kernel on its inputs, no forward scatter);
  3. sustained — the sustained-traffic configuration (N=10,000, k-regular
     K=8, Poisson 1,000 broadcasts a round, 1,000,000 broadcasts, window
     16,384, seg_len 8) through ``repro_torch.api.run``: full delivery,
     the window held, one fused_sweep launch a round and one
     retire_reduce launch a retirement sweep;
  4. gated — the paper-scale Fig. 7 churn run (N=50,000, ring K=17, 12
     broadcasts, 128 link additions and removals in 16 rounds, delay 3,
     snapshot at the last churn round, oracle on): full delivery, a
     clean oracle, deliver_sweep and frontier_sweep launched every round;
  5. parity — a sustained N=2,048 windowed run and an N=1,024 churn run
     on the card and on the CPU (plain versions): byte-identical.

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
    launches = {}
    launches.update(sustained_phase(torch))
    # -- 4. gated main path ------------------------------------------- #
    launches.update(gated_phase(torch))
    # -- 5. whole-engine parity, card vs CPU --------------------------- #
    parity_phase(np)

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
    return dict(
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
    }


def _call(torch, fn, names, inputs, inplace):
    """Call ``fn`` on fresh copies of the arguments it writes."""
    args = [inputs[k].clone() if k in inplace else inputs[k] for k in names]
    return fn(*args)


def _max_err(torch, got, want) -> int:
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
    n, w = inp["arr"].shape
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
            got = got if isinstance(got, tuple) else (got,)
            err = _max_err(torch, got, want)
            if err:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version on {tuple(inp['arr'].shape)}"
                                     f": max |err| {err}")
    torch.cuda.synchronize()
    emit("kernels_small", cases=len(cases), kernels=sorted(calls),
         max_abs_err=0)


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

    entries = []
    for name, (kernel, plain, names, inplace, launch, outs) in calls.items():
        inp = store[name]
        got = _call(torch, kernel, names, inp, inplace)
        want = plain(*[inp[k] for k in names])
        got = got if isinstance(got, tuple) else (got,)
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
            name=name, route="cuda", source=f"{KSRC}/{name}.cu",
            replaces=f"{TPU_KERNELS}:{TPU_LINES[name]}", launches=None,
            max_abs_err=err, ms=min(ms, ms2), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape=list(inp["arr"].shape), k=(inp["adj"].shape[1]
                                             if "adj" in inp else None),
            ms_repeats=[ms, ms2], wrapper_ms=wrapper_ms)
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
             "retire_reduce": 178}


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
    assert launches["deliver_sweep"] == launches["frontier_sweep"] == 0
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
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={k: launches[k] for k in ("fused_sweep",
                                            "retire_reduce")})
    return {k: launches[k] for k in ("fused_sweep", "retire_reduce")}


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
                                            "frontier_sweep")})
    return {k: launches[k] for k in ("deliver_sweep", "frontier_sweep")}


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
