"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics and the result line.

The order of a run:

1. set-up — the driver draws the cell's inputs from the seed, builds
   the program's objects, and warms the cell's own shapes (the first
   use builds the program's kernels into the checkout).  ``setup_s``
   runs from the start of the process to the end of this.  A traced
   run whose metrics read a roofline warms with one whole repetition
   with each roofline kernel's wrapper wrapped, which counts the bound
   of its launches and covers every shape the driver's warm-up does.
2. the window — whole repetitions of the cell's input back to back
   until ``seconds`` have passed (the last one finishes), on the host
   clock, ended by a device synchronisation.  With ``--trace 1`` the
   device trace and the program's spans cover it, after the profiler's
   first start; a per-layer reader that reads the untraced window
   (``UNTRACED = True``, such as a host-clock tail that the tracer's
   cost a launch would move) first has a window of its own with
   tracing off, as a ``--trace 0`` run has it.
3. the peak device memory (after a counting set-up, of the windows
   alone), then the check that no module of JAX or of the JAX package
   was loaded.
4. the reference works out the answers again and judges every
   repetition of both windows; then the metrics are read.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
import traceback
from typing import Dict, TextIO

from .readers import Context
from .spec import BENCH_DIR, CellSpec, load_driver, load_metric, load_roofline
from .trace import Profiler, clock_offset_ns, idle_by_label

__all__ = ["BANNED", "banned_modules", "measure", "count_rooflines"]

#: top-level module names no run may load: JAX and the JAX package
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & BANNED)


def _guard(err: TextIO) -> bool:
    """True, after naming them on ``err``, if banned modules are loaded."""
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=err)
    return bool(found)


def _sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def count_rooflines(torch, cell, kernels, peaks: dict) -> Dict[str, tuple]:
    """Run one repetition with each kernel's wrapper wrapped; returns
    kernel -> (launches, summed bound seconds).  Each launch's bound is
    summed on the device, so the count never waits for the card."""
    mods = {k: load_roofline(k) for k in kernels}
    totals = {k: [0, 0.0] for k in kernels}
    undo = []
    for kernel, mod in mods.items():
        owner = importlib.import_module(mod.WRAPPER[0])
        orig = getattr(owner, mod.WRAPPER[1])

        def counted(*args, _orig=orig, _mod=mod, _tot=totals[kernel]):
            snap = _mod.before(torch, args)
            out = _orig(*args)
            nbytes, ops = _mod.count(torch, args, snap)
            _tot[0] += 1
            _tot[1] = _tot[1] + torch.maximum(
                nbytes.double() / peaks["hbm_bytes_per_s"],
                ops.double() / peaks["core_ops_per_s"])
            return out
        setattr(owner, mod.WRAPPER[1], counted)
        undo.append((owner, mod.WRAPPER[1], orig))
    try:
        cell.rep(spans=False)
    finally:
        for owner, name, orig in undo:
            setattr(owner, name, orig)
    return {k: (v[0], float(v[1])) for k, v in totals.items()}


def _device_info(torch, device: str, peak: int) -> dict:
    if device.startswith("cuda"):
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=1, memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def _window(cell, seconds: float, spans: bool) -> tuple:
    """Repetitions back to back until ``seconds`` have passed; returns
    ``(reps, error)``, the traceback of a failed repetition or None."""
    reps, error = [], None
    t0 = time.perf_counter()
    try:
        while True:
            reps.append(cell.rep(spans=spans))
            if time.perf_counter() - t0 >= seconds:
                break
    except Exception:               # the timed path failed: not correct
        error = traceback.format_exc()
    return reps, error


def measure(spec: CellSpec, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, out: TextIO = sys.stdout,
            err: TextIO = sys.stderr) -> int:
    """Run the cell and print its result line; returns the exit code."""
    import torch
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    metrics = spec.per_layer if trace else spec.end_to_end
    per_layer = {m["name"]: load_metric(m["name"]) for m in spec.per_layer}
    readers = per_layer if trace else {m["name"]: load_metric(m["name"])
                                       for m in metrics}
    untraced_readers = {name: r for name, r in per_layer.items()
                        if getattr(r, "UNTRACED", False)}
    apart = trace and bool(untraced_readers)   # an untraced window first
    cell = load_driver(spec).Cell(spec, seed, device)
    kernels = sorted({r.ROOFLINE for r in readers.values()
                      if hasattr(r, "ROOFLINE")}) if trace else []
    rooflines, took = {}, {}
    if kernels:
        peaks = json.loads((BENCH_DIR / "roofline" / "peaks.json")
                           .read_text())
        tick = time.perf_counter()
        rooflines = count_rooflines(torch, cell, kernels, peaks)
        took["roofline_s"] = time.perf_counter() - tick
    else:
        cell.warm()
    _sync(torch, device)
    if kernels and on_card:         # the count's snapshots are no peak
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    untraced, error = [], None
    if apart:
        untraced, error = _window(cell, seconds, False)
        _sync(torch, device)
    prof = Profiler(torch) if trace and on_card else None
    if prof is not None:
        prof.warm(device)
        _sync(torch, device)
    offset = clock_offset_ns()
    reps = []
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    if error is None:
        reps, error = _window(cell, seconds, trace)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    if not trace:
        untraced = reps
    if prof is not None:
        tick = time.perf_counter()
        prof.stop()
        took["trace_stop_s"] = time.perf_counter() - tick
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if _guard(err):
        return 3
    if error is not None:
        print(error, file=err)

    ctx = Context(setup_s=setup_s, wall_s=wall, reps=reps,
                  untraced=untraced, rooflines=rooflines)
    if prof is not None:
        tick = time.perf_counter()
        ctx.trace = prof.trace()
        took["trace_read_s"] = time.perf_counter() - tick

    t_ref = time.perf_counter()
    judged = untraced + reps if apart else reps
    verdict = cell.judge(judged, device)
    took["reference_s"] = time.perf_counter() - t_ref
    print(f"time setup_s {setup_s} window_s {wall} reps "
          f"{[(r.t1_ns - r.t0_ns) / 1e9 for r in reps]} {took}", file=err)
    if apart:
        print(f"time untraced reps "
              f"{[(r.t1_ns - r.t0_ns) / 1e9 for r in untraced]}", file=err)
    print(f"warm {getattr(cell, 'warm_info', None)}", file=err)
    if not trace:                   # the untraced readers, for their spread
        for name, mod in untraced_readers.items():
            print(f"untraced {name} {mod.read(ctx)}", file=err)
    checks = dict(verdict.checks)
    checks["reps_failed"] = (int(error is not None), 0)
    checks["empty_window"] = (int(not reps or (apart and not untraced)), 0)
    correct = all(v <= lim for v, lim in checks.values())

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = _device_info(torch, device, peak)
    line = dict(correct=bool(correct), attempted=int(verdict.attempted),
                failed=int(verdict.failed), metrics=values, device=dev)
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        spans = [(n, a + offset, b + offset)
                 for r in reps for (n, a, b) in r.spans]
        line["breakdown"] = dict(
            device_ops=[[name[:160], s] for name, s in ctx.trace.top_ops(10)],
            idle_gaps=idle_by_label(ctx.trace, spans,
                                    "between repetitions", 10))
    if _guard(err):
        return 3
    print(f"time total_s {time.perf_counter() - t_start}", file=err)
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        print(f"check {name} {v} limit {lim}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0
