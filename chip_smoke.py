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
     more than 65,535 row chunks, fused_sweep's pull on tables with -1,
     out-of-range and duplicate targets, a row of more than 32 in-edges,
     K of 1, 3, 8 and 17 and mixed delays (and its inverse table rebuilt
     after an edit of adj), then the inputs the main path gives each
     kernel, captured from short runs at the main-path shapes
     (N=10,000 x W=16,384 x K=8 sustained traffic; N=50,000 x W=140 x
     K=17 paper-scale churn; N=65,536 x W=1,024 serving), with the time
     of the bare kernel launch, of the wrapper around it, of the plain
     version, and the bound; fused_sweep at the sustained and at the
     serving shape, each also with the time of its plane pass alone
     (pass 1: deliver, counts and forward mask, no forward);
     frontier_sweep at three rounds of the churn run: 58 (busy, just
     after the last link addition), 30 (idle) and 63 (the most flushed
     sends);
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
     records byte-identical;
  8. sharded_churn — the Fig. 7 churn configuration of phase 4 through
     the sharded engine (``engine="sharded"``, one rank, window
     M_total = 140, scan auto: live gating keeps every segment on the
     generic body): full delivery, a clean oracle, the delivered matrix,
     series and NetStats byte-identical to the windowed engine on the
     card, slot_frontier launched K times a round and ring_apply K times
     a round and hop;
  9. scale — BENCH_scale.json's configuration (N = 1,048,576, k-regular
     K = 4, max_delay 1, Poisson 4 a round, 512 broadcasts, window 128,
     seg_len 16, seed 0, histograms off, aggregate collection, scan
     auto, one rank): full delivery, no expired column, and the counts
     of BENCH_scale.json (166 rounds, 2,147,483,648 sends, 536,870,912
     deliveries, peak 116 live columns, mean latency 9.877 rounds), with
     the engine wall, steady sends/s, fast and generic segments, the
     segment spans and peak device memory;
 10. scale_scan_off — the same with ``scan="off"``: every round through
     the generic body, so the two sharded kernels run at N = 2^20; its
     series and aggregates byte-identical to phase 9's;
 11. the sharded kernels — slot_frontier (gating on and off) and
     ring_apply byte-equal to their plain versions on small random
     inputs (odd and single-column windows, an all-INF plane, duplicate
     targets, a second shard's offset with half the targets dropped),
     ring_apply also on its word walk's cases (W of 1, 3, 4, 5, 128, 140
     and 141, offsets 0 and n, duplicate, dropped and all-foreign
     targets, all-INF vals, a dest already lower, vals off a 16-byte
     boundary, up to 600,000 rows), and on the inputs phases 8 and 10
     gave them, timed, with ``scatter_reduce_(..., "amin")`` as
     ring_apply's library yardstick; then deliver_sweep byte-equal on
     its row walk's cases (W of 1, 3, 4, 5, 127, 128, 140, 141 and 513,
     crashed rows, all-delivered and all-undelivered planes, arr == t
     on delivered cells, planes off a 16-byte boundary, up to 600,000
     rows) and on phase 10's round-40 inputs (N = 2^20, W = 128), timed
     and bounded in its kernels-line entry; and frontier_sweep
     byte-equal on its walk's cases (the same widths, K of 1, 3, 17, 32,
     33 and 40, gates equal to d, above t and at -1, cells at t on app
     and ping columns, slots both flushing and forward-eligible, targets
     -1, out of range, duplicated and the sender's own row, all-INF and
     already-lower arr, all rows flushing and none, delivered off a
     16-byte boundary, up to 600,000 rows);
 12. sharded parity — the sharded engine on the card and on the CPU at
     one rank: every scenario builder at N = 256 with scan on and off
     and the full delivered matrix, and an N = 1,024 bursty/defer live
     run with provenance and the audit in fail mode: byte-identical;
 13. lm_kernels — rglru_scan, ssd_scan and flash_attention against
     their plain versions on the card, within float32 2e-5 and bfloat16
     2e-2: small random cases first (odd and padded S and W, S below a
     chunk or block, h0 on and off; rglru_scan at S of 1, 15, 16, 17
     and 8,192, W one past a 512-column block, a within 1e-4 of 1;
     H/KV of 1 to 80, kv padded past
     seq_kv, q longer than kv, D 16-256, both types; ssd_scan on both of
     its bodies, with P of 8 to 64 in slices of 32, N of 16 to 200, B of
     2, H of 1 to 80),
     then (after phases 14-15) the inputs the serving runs gave them and
     flash on q/k/v of a recurrentgemma-9b attention layer at a
     2,048-token prefill (also held against the layer's own attention
     output) and at a yi-6b train_4k-like shape, each timed (bare
     launch, wrapper, plain, scaled_dot_product_attention for flash)
     and bounded; ssd_scan on the mamba2-2.7b prefill's inputs must run
     its tensor-core body, and stay within the bf16 tolerance of a
     float64 evaluation;
 14. lm_serve_recurrentgemma — recurrentgemma-9b at full width and
     depth (38 layers: 26 RG-LRU, 12 local attention; f32 weights from
     a seeded generator, bf16 compute) through ServingEngine: 4 slots,
     max_len 4,096, 8 prompts of 512-2,560 seeded random tokens (one
     past the 2,048 window), 16 greedy tokens each; every request done,
     every logit finite, 26 rglru_scan launches a prefill;
 15. lm_serve_mamba2 — the same for mamba2-2.7b (64 Mamba-2 layers),
     prompts of 512-2,048 tokens, 64 ssd_scan launches a prefill;
 16. lm_parity — the dense, SSM and hybrid smoke() configs in float32
     through ServingEngine on the card and on the CPU with the same
     weights: identical greedy tokens, logits within 2e-4; then
     ``python -m repro_torch.launch.serve --arch recurrentgemma-9b``.

 17. crossval — ``metrics.crossval`` (and the oracle) through the front
     door on the card at N=256 (the twin of tests/test_vecsim.py:33):
     dynamics none, link_add, churn and crash, each on the vec engine,
     the windowed engine (window from the budget, full delivered
     matrix) and the sharded engine (one rank), plus one Poisson live
     run; every crossval_ok true, every oracle clean, each run
     byte-identical to the same spec on the CPU, the vec side's and the
     exact side's walls printed apart; fused_sweep, deliver_sweep,
     frontier_sweep, retire_reduce and latency_hist each launched;
 18. table1 — benchmarks/bench_table1.py's cells through the front
     door: the exact arm (N = 50, 100, 200, m_app = N/2, ring K =
     max(3, N/32), pc and vc, oracle on) and the vec arm at N=50,000
     (ring K=6, 32 uniform broadcasts, seed N): pc on the vec engine
     (fused_sweep a round) and vc on the vector-clock engine, both on
     the card and on the CPU, byte-equal in every field; overhead
     bytes a message, comparisons a delivery, space entries, card and
     CPU walls, and the vc drain's iterations and card ms; then a vc
     cross-validation at N=256 on the card with equal clocks.

Then the kernels line (all eleven kernels; launches summed over every
main-path phase, 17 and 18 included), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Needs
one CUDA card; exits non-zero without one.

    python3 chip_smoke.py --ranks 4

runs only the multi-card check instead: phases 8, 9 and 10's
configurations at one rank in this process and then over 2 and over the
given number of ranks, which ``repro_torch.api.run`` starts itself
(NCCL, one card a rank), each byte-identical to the one-rank run.  It
needs that many cards.

    python3 chip_smoke.py --ab DIR

compares engine walls with another checkout on the same card (DIR, a
directory inside this checkout, e.g. the parent commit unpacked by
``git archive`` into build/parent): phase 10's run four times (the first
warms up), phase 4's four times, phase 15 twice and phase 14 twice, with
deliver_sweep timed on phase 10's round-40 inputs, frontier_sweep on
phase 4's rounds 58, 30 and 63 and rglru_scan on phase 14's first
prefill, in a process of each checkout in turn, DIR, this, this, DIR.
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
# the fused_sweep call of the 20,000-submission serving run whose inputs
# are held: inside the arrival spike, with the window full
SERVE_FUSED_CALL = 256
# the device type the main-path runs must report
CARD = "cuda"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    if argv:
        if len(argv) == 2 and argv[0] == "--ab":
            ab_phase(argv[1])
            _finish(torch)
            return 0
        if len(argv) != 2 or argv[0] != "--ranks" or int(argv[1]) < 2:
            print("usage: chip_smoke.py [--ranks N>=2 | --ab DIR]",
                  file=sys.stderr)
            return 2
        ranks_phase(torch, np, int(argv[1]))
        _finish(torch)
        return 0

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
    # -- 8-10. the sharded engine: churn, scale, scale with scan off --- #
    print(json.dumps({"phase": "devices",
                      "cuda_device_count": torch.cuda.device_count()}),
          flush=True)
    shard_calls = _shard_ops()
    captured = {}
    churn = sharded_churn_phase(torch, np, captured)
    scale = scale_phase(torch)
    scale_off = scale_scan_off_phase(torch, np, scale, captured)
    for name in ("slot_frontier", "ring_apply"):
        launches[name] = churn[name] + scale_off[name]
    # deliver_sweep runs a round on the gated, sharded_churn and
    # scale_scan_off paths
    launches["deliver_sweep"] += churn["deliver_sweep"] + \
        scale_off["deliver_sweep"]
    # -- 11. the sharded kernels against their plain versions ---------- #
    check_shard_small(torch, np, dev, shard_calls)
    entries += check_shard_main_path(torch, shard_calls, captured)
    check_deliver_small(torch, dev)
    check_frontier_small(torch, dev)
    deliver = next(e for e in entries if e["name"] == "deliver_sweep")
    deliver["at_scale"] = _deliver_at_scale(torch, captured)
    captured.clear()
    # -- 12. sharded parity, card vs CPU ------------------------------ #
    sharded_parity_phase(np)
    for e in entries:
        e["launches"] = launches[e["name"]]
    # -- 13-16. the LM substrate: kernels, serving, card vs CPU -------- #
    entries += lm_phases(torch, np, dev)
    # -- 17-18. the exact engine's cross-validation and Table 1 -------- #
    extra = crossval_phase(torch, np)
    for key, v in table1_phase(torch, np).items():
        extra[key] = extra.get(key, 0) + v
    for e in entries:
        e["launches"] += extra.get(e["name"], 0)

    # not measured here: the card ms of the earlier designs of five
    # kernels, copied from PERF.md's kernel table, for the eye beside
    # this run's
    emit("earlier_design_ms", measured_in_this_run=False,
         source="PERF.md section 6, rows 2, 3, 8, 10 and 11",
         frontier_sweep={"gated_round_58": 0.13204800337553024,
                         "gated_round_30": 0.05544000118970871,
                         "gated_round_63": 0.1526079997420311},
         ring_apply={"sharded_churn": 0.04427199997007847,
                     "scale_scan_off": 0.5357600152492523},
         ssd_scan={"lm_serve_mamba2": 2.5712960958480835},
         deliver_sweep={"gated": 0.05241600051522255,
                        "scale_scan_off": 0.7481440007686615},
         rglru_scan={"lm_serve_recurrentgemma": 0.22115200012922287})
    print(json.dumps({"kernels": entries}), flush=True)
    _finish(torch)
    return 0


# one turn of --ab, run by each checkout's own chip_smoke.py: phase 10's
# run four times (deliver_sweep's inputs of round 40 kept in the first and
# timed after), phase 4 four times, then once for each of frontier_sweep's
# three rounds (its inputs kept and timed after), phase 15 twice, and
# phase 14 twice (rglru_scan's inputs of the first prefill timed after
# each); the call numbers are filled in by ab_phase
AB_TURN = r"""
import sys
sys.path.insert(0, "src")
import numpy as np, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
call = cs._ops()["deliver_sweep"]
store, undo = cs._capture(torch, {"deliver_sweep": call}, {"deliver_sweep": 41})
try:
    walls = [cs._scale_run(torch, cs.scale_spec("off"))[3]]
finally:
    undo()
walls += [cs._scale_run(torch, cs.scale_spec("off"))[3] for _ in range(3)]
cs.emit("scale_scan_off_walls", walls=walls)
cs._entry(torch, "deliver_sweep", call, store.pop("deliver_sweep"))
for _ in range(4):
    cs.gated_phase(torch)
from repro_torch.api import build_scenario, run
gated = cs.gated_spec()
call = cs._ops()["frontier_sweep"]
for c in (int(build_scenario(gated).add_round[-1]) + 1, %(idle)d, %(flush)d):
    store, undo = cs._capture(torch, {"frontier_sweep": call},
                              {"frontier_sweep": c})
    try:
        run(gated)
    finally:
        undo()
    inp = store.pop("frontier_sweep")
    e = cs._entry(torch, "frontier_sweep", call, inp)
    cs.emit("frontier_at", round=int(inp["t"]), ms=e["ms"],
            bound_ms=e["bound_ms"], max_abs_err=e["max_abs_err"])
    del inp
for _ in range(2):
    cs.lm_serve_phase(torch, np, "mamba2-2.7b")
for _ in range(2):
    _, rg, _ = cs.lm_serve_phase(torch, np, "recurrentgemma-9b")
    cs.emit("kernel", **cs._lm_entry(torch, np, "rglru_scan", rg))
    del rg
"""


def ab_phase(other: str) -> None:
    """--ab: the walls of scale_scan_off, gated, lm_serve_mamba2 and
    lm_serve_recurrentgemma, and the card ms of deliver_sweep,
    frontier_sweep (at its three rounds) and rglru_scan on their
    main-path inputs, in another checkout and in this one, alternating
    on this card (each checkout's own bound).  The other checkout lies
    inside this one (e.g. under the gitignored build/), so that nothing
    is run or built outside it."""
    root = os.path.realpath(ROOT)
    path = os.path.realpath(os.path.join(root, other))
    if os.path.commonpath([path, root]) != root or path == root:
        raise SystemExit(f"--ab: {other} is not a directory inside {root}")
    trees = {"other": path, "this": root}
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, "-c", AB_TURN % dict(
                idle=FRONTIER_IDLE_CALL, flush=FRONTIER_FLUSH_CALL)],
            cwd=trees[name],
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=os.path.join(trees[name], "src")))
        if proc.returncode:
            raise RuntimeError(f"--ab turn in {trees[name]} failed:\n"
                               + proc.stdout[-2000:] + proc.stderr[-2000:])
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            keep = ("walls", "engine_wall_seconds", "tokens_per_sec",
                    "prefill_ms", "decode_ms_per_tick", "name", "shape",
                    "ms", "bound_ms", "max_abs_err", "round")
            emit("ab_" + rec["phase"], tree=name, **{
                k: v for k, v in rec.items() if k in keep})


def _finish(torch) -> None:
    """The card's name and power limit, then the last line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
        rounds=22,
        # slot_frontier: one link slot's tables
        gate_k=t(np.where(rng.random(n) < 0.5, rng.integers(0, 15, n), -1),
                 torch.int32),
        delay_k=t(rng.integers(1, 4, n), torch.int32),
        do_k=t(rng.random(n) < 0.5, torch.bool),
        fwd_k=t(rng.random(n) < 0.6, torch.bool),
        gating=True,
        # ring_apply: the second shard of two (off = n), targets in
        # [0, 2n): about half are dropped, the rest often coincide
        dest=t(np.where(rng.random((n, w)) < 0.5, rng.integers(0, 40, (n, w)),
                        INF), torch.int32),
        vals=t(np.where(rng.random((n, w)) < 0.5, rng.integers(2, 40, (n, w)),
                        INF), torch.int32),
        tgt=t(rng.integers(0, 2 * n, n), torch.int32),
        off=n)


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

    def fused_out(inp):
        # the counts, the forward mask and the inverse table of adj
        n, w = inp["arr"].shape
        return counts(inp) + [ops.forward_mask(n, w, inp["arr"].device),
                              *ops.inverse_table(inp["adj"])]

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
                        _launch_fused(3), fused_out),
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


def _launch_fused(passes):
    """fused_sweep's bare launch in ``_ops``' argument order; ``passes=1``
    is its plane pass alone."""
    from repro_torch.core.vecsim.kernels import ops

    def launch(arr, delivered, crashed, adj, delay, fwd_ok, is_app, t, napp,
               nping, bits, in_ptr, in_slot):
        ops.launch_fused_sweep(arr, delivered, crashed, delay, fwd_ok, is_app,
                               t, napp, nping, bits, in_ptr, in_slot, passes)
    return launch


def _shard_ops():
    """The ``_ops`` entries of the sharded engine's two kernels."""
    import torch
    from repro_torch.core.vecsim.kernels import ops, ref

    def frontier_out(inp):
        d = inp["delivered"]
        return [torch.empty_like(d),
                torch.zeros((), dtype=torch.int32, device=d.device)]

    return {
        "slot_frontier": (ops.slot_frontier, ref.slot_frontier_ref,
                          ("delivered", "gate_k", "delay_k", "do_k", "fwd_k",
                           "is_app", "t", "gating"), (),
                          ops.launch_slot_frontier, frontier_out),
        "ring_apply": (ops.ring_apply, ref.ring_apply_ref,
                       ("dest", "vals", "tgt", "off"), ("dest",),
                       ops.launch_ring_apply, None),
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


# cycles the card spins ahead of a queued timing: about 1 ms at the
# H100's clock, more than the host takes to queue the call behind it
SPIN_CYCLES = 2_000_000


def _time_ms(torch, fn, names, inputs, inplace, reps, make_outs=None,
             queued=True):
    """Median CUDA-event time of one call of ``fn``.  The copies of the
    in-place arguments, and the outputs ``make_outs`` allocates for a
    bare launch, are made outside the timed interval.  ``queued``: the
    card spins before the start event while the host queues the call,
    so the interval is the card's time alone, not the host's pace (a
    kernel of ~20 us is shorter than its launch from Python); without
    it the interval is a caller's latency, host work included.  The L2
    cache is not flushed: the planes the churn-shape kernels get (28 MB
    each) sit partly in the 50 MB L2 on the path too, as the sweep
    before them has just touched them."""
    pairs = []
    for _ in range(reps):
        args = [inputs[k].clone() if k in inplace else inputs[k]
                for k in names]
        if make_outs is not None:
            args += make_outs(inputs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
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
    if name == "ring_apply":
        # tgt, the vals cells of owned rows, and each 32-byte dest sector
        # a sent value lowers, read and written
        n, w = inp["dest"].shape
        tl = inp["tgt"].to(torch.int64) - inp["off"]
        owned = int(((tl >= 0) & (tl < n)).sum())
        changed = plain_out != inp["dest"]
        nbytes = 4 * n + 4 * w * owned + 64 * _sectors(torch, changed)
        ops = 3 * w * owned
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CORE_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    n, w = inp["delivered"].shape
    cells = n * w
    k = inp["adj"].shape[1] if "adj" in inp else 0
    d, t = inp["delivered"], inp.get("t")
    if name == "slot_frontier":
        # read delivered and write vals, 8 bytes a cell, plus the row
        # tables, is_app and the count
        nbytes = 8 * cells + 10 * n + w + 4
        ops = 6 * cells
    elif name in ("fused_sweep", "deliver_sweep"):
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
        # each slot table only where the output depends on it: do on rows
        # with an app cell before t, fwd_ok on rows with a cell at t, the
        # gates of the do slots of the former, adj and delay of the
        # slots that send; the changed arr sectors read and written
        do, fwd, gate = inp["do"], inp["fwd_ok"], inp["gate"]
        now = d == t
        early = (d < t) & inp["is_app"][None, :]
        rows_early = early.any(dim=1)
        rows_now = now.any(dim=1)
        latest = torch.where(early, d, torch.full_like(d, -2)).amax(dim=1)
        flush_slot = do & rows_early[:, None] & (latest[:, None] >= gate)
        send_slot = (fwd & rows_now[:, None]) | flush_slot
        a_changed = plain_out[0] != inp["arr"]
        nbytes = (4 * cells + w + 8 + k * int(rows_early.sum())
                  + k * int(rows_now.sum())
                  + 4 * int((do & rows_early[:, None]).sum())
                  + 8 * int(send_slot.sum())
                  + 64 * _sectors(torch, a_changed))
        # a compare a cell, a compare and a min a send
        sends = int(sum(((now & fwd[:, kk, None])
                         | (early & do[:, kk, None]
                            & (d >= gate[:, kk, None]))).sum()
                        for kk in range(k)))
        ops = cells + 2 * sends
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
    of call number ``wanted[name]`` of each are kept (cloned), under
    ``name``; where ``wanted[name]`` is a tuple of call numbers, those of
    each, under ``(name, call)``.  Returns the store and an undo
    function."""
    from repro_torch.core.vecsim import kernels as kx
    store, seen, saved = {}, {}, {}
    for name, (_, _, names, *_) in calls.items():
        if name not in wanted:
            continue
        orig = getattr(kx, name)
        saved[name] = orig

        def rec(*args, _name=name, _names=names, _orig=orig):
            seen[_name] = seen.get(_name, 0) + 1
            want = wanted[_name]
            if seen[_name] in (want if isinstance(want, tuple) else (want,)):
                key = (_name, seen[_name]) if isinstance(want, tuple) \
                    else _name
                store[key] = {
                    k: (a.clone() if isinstance(a, torch.Tensor) else a)
                    for k, a in zip(_names, args)}
            return _orig(*args)
        setattr(kx, name, rec)

    def undo():
        for name, orig in saved.items():
            setattr(kx, name, orig)
    return store, undo


def check_small(torch, np, dev):
    """Every kernel against its plain version on small random inputs."""
    calls = {**_ops(), **_shard_ops()}
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
    check_fused_pull(torch, np, dev)


def check_fused_pull(torch, np, dev):
    """fused_sweep against its plain version on the tables its pull must
    read right: targets -1, N and beyond (dropped), duplicate edges, one
    row with more than 32 in-edges (the in-edge batches), K of 1, 8 and
    17, mixed delays, windows that are not a multiple of 4 or 32, an
    all-retired window; and its inverse table rebuilt after an in-place
    edit of adj."""
    from repro_torch.core.vecsim.kernels import ops
    kernel, plain, names, inplace = _ops()["fused_sweep"][:4]
    rng = np.random.default_rng(20263)
    cases = max_in = 0
    for n, w, k in ((40, 33, 1), (64, 257, 8), (50, 31, 17), (200, 300, 17),
                    (300, 1, 8), (129, 1000, 3)):
        inp = _random_inputs(torch, np, rng, n, w, k, dev)
        adj = rng.integers(-2, n + 3, (n, k))
        adj[rng.random((n, k)) < 0.2] = -1
        adj[:, 0] = np.where(rng.random(n) < 0.5, 0, adj[:, 0])  # > 32 in
        adj[1] = adj[1, 0]                                        # duplicates
        inp["adj"] = torch.from_numpy(adj.astype(np.int32)).to(dev)
        inp["delay"] = torch.from_numpy(
            rng.integers(1, 6, (n, k)).astype(np.int32)).to(dev)
        ptr, _ = ops.build_inverse_table(inp["adj"])
        max_in = max(max_in, int((ptr[1:] - ptr[:-1]).max()))
        # most cells delivered at t, so that the forward has work
        t = inp["t"]
        inp["delivered"] = torch.where(
            torch.from_numpy(rng.random((n, w)) < 0.5).to(dev),
            torch.full_like(inp["delivered"], t), inp["delivered"])
        variants = [{}, dict(arr=torch.full_like(inp["arr"], INF),
                             delivered=torch.full_like(inp["delivered"], -1))]
        for var in variants:
            case = dict(inp, **var)
            got = _call(torch, kernel, names, case, inplace)
            want = plain(*[case[key] for key in names])
            err = _max_err(torch, got, want)
            if err:
                raise AssertionError(f"fused_sweep differs from its plain "
                                     f"version on ({n}, {w}, {k}) with "
                                     f"{sorted(var)}: max |err| {err}")
            cases += 1
    # the cache follows an in-place edit of adj
    adj = inp["adj"].clone()
    first = ops.inverse_table(adj)
    adj[0, 0] = 5
    second = ops.inverse_table(adj)
    if second is first or not all(torch.equal(a, b) for a, b in zip(
            second, ops.build_inverse_table(adj))):
        raise AssertionError("the inverse table was not rebuilt after an "
                             "edit of adj")
    torch.cuda.synchronize()
    emit("kernels_fused_pull", cases=cases, k=[1, 3, 8, 17],
         max_in_degree=max_in, max_abs_err=0)


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
    # frontier_sweep also at an idle and at the flush-heaviest round
    fr_calls = (t_cap + 1, FRONTIER_IDLE_CALL, FRONTIER_FLUSH_CALL)
    store2, undo = _capture(torch, calls, {"deliver_sweep": t_cap + 1,
                                           "frontier_sweep": fr_calls})
    try:
        run(gated)
    finally:
        undo()
    frontier = [store2.pop(("frontier_sweep", c)) for c in fr_calls]
    store2["frontier_sweep"] = frontier[0]
    store.update(store2)
    # the serving shape, from the spike of a shorter serving run
    store3, undo = _capture(torch, calls, {"latency_hist": 16,
                                           "fused_sweep": SERVE_FUSED_CALL})
    try:
        run(serve_spec(messages=20_000))
    finally:
        undo()
    serve_fused = store3.pop("fused_sweep")
    store.update(store3)
    # retire_scan on retire_reduce's inputs (no engine calls it)
    store["retire_scan"] = store["retire_reduce"]

    entries = [_entry(torch, name, call, store[name])
               for name, call in calls.items()]
    # fused_sweep at the serving shape rides in its sustained entry
    fused = next(e for e in entries if e["name"] == "fused_sweep")
    fused["at_serve"] = {
        key: v for key, v in _entry(torch, "fused_sweep", calls["fused_sweep"],
                                    serve_fused).items()
        if key in ("shape", "k", "ms", "ms_repeats", "wrapper_ms", "plain_ms",
                   "bound_ms", "bound_by", "max_abs_err", "plane_pass_ms")}
    fused["at_serve"]["round"] = int(serve_fused["t"])
    # frontier_sweep's idle and flush-heaviest rounds ride in its entry
    entry = next(e for e in entries if e["name"] == "frontier_sweep")
    entry["round"] = int(frontier[0]["t"])
    for key, inp in zip(("at_idle", "at_flush"), frontier[1:]):
        entry[key] = {k: v for k, v in _entry(
            torch, "frontier_sweep", calls["frontier_sweep"], inp).items()
            if k in _AT_SCALE_KEYS}
        entry[key]["round"] = int(inp["t"])
    store.clear()
    frontier.clear()
    torch.cuda.empty_cache()
    return entries


def _entry(torch, name, call, inp):
    """The kernels-line entry of ``name`` on the inputs ``inp``: checked
    against its plain version, timed (bare launch, wrapper, plain) and
    bounded."""
    kernel, plain, names, inplace, launch, outs = call
    got = _call(torch, kernel, names, inp, inplace)
    want = plain(*[inp[k] for k in names])
    err = _max_err(torch, got, want)
    if err:
        raise AssertionError(f"{name} differs from its plain version "
                             f"at the main-path shape: max |err| {err}")
    plain_out = want[0] if name == "slot_frontier" else want
    bound_ms, bound_by = _bound(torch, name, inp, plain_out)
    ms = _time_ms(torch, launch, names, inp, inplace, 20, outs)
    wrapper_ms = _time_ms(torch, kernel, names, inp, inplace, 20,
                          queued=False)
    plain_ms = _time_ms(torch, plain, names, inp, (), 5, queued=False)
    ms2 = _time_ms(torch, launch, names, inp, inplace, 20, outs)
    plane = inp["dest"] if name == "ring_apply" else inp["delivered"]
    entry = dict(
        name=name, route="cuda", source=f"{KSRC}/{SOURCES[name]}",
        replaces=f"{TPU_KERNELS}:{TPU_LINES[name]}", launches=None,
        max_abs_err=err, ms=min(ms, ms2), plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=list(plane.shape),
        k=(inp["adj"].shape[1] if "adj" in inp else None),
        ms_repeats=[ms, ms2], wrapper_ms=wrapper_ms)
    if name == "latency_hist":
        entry["cols"] = int(inp["cols"].shape[0])
    if name == "fused_sweep":
        # its plane pass alone (pass 1: deliver, counts, forward mask)
        entry["plane_pass_ms"] = _time_ms(torch, _launch_fused(1), names,
                                          inp, inplace, 20, outs)
    if name == "slot_frontier":
        entry["gating"] = bool(inp["gating"])
    if name in ("slot_frontier", "frontier_sweep"):
        entry["flushed"] = int(want[1])
    if name == "ring_apply":
        entry["library_ms"] = _library_ring_apply_ms(torch, inp, want)
        entry["off"] = int(inp["off"])
    emit("kernel", **entry)
    return entry


def _library_ring_apply_ms(torch, inp, want):
    """The time of the one PyTorch call that computes ring_apply at one
    rank, ``dest.scatter_reduce_(0, idx, vals, "amin")`` with every
    target owned; rows without a target (-1, an empty slot) send only
    INF, so they are pointed at row 0, where min with INF changes
    nothing.  Its result is held against the kernel's."""
    dest, vals, tgt = inp["dest"], inp["vals"], inp["tgt"]
    n, w = dest.shape
    assert inp["off"] == 0 and bool((tgt < n).all())
    assert bool((vals[tgt < 0] == INF).all())
    idx = tgt.to(torch.int64).clamp(min=0)[:, None].expand(n, w).contiguous()
    lib = dest.clone().scatter_reduce_(0, idx, vals, reduce="amin")
    if not torch.equal(lib, want):
        raise AssertionError("scatter_reduce_ differs from ring_apply")

    def library(d, v, i):
        d.scatter_reduce_(0, i, v, reduce="amin")
    return _time_ms(torch, library, ("dest", "vals", "idx"),
                    dict(dest=dest, vals=vals, idx=idx), ("dest",), 20)


# frontier_sweep's calls in the gated run (call c is round c - 1): round
# 30, idle (no delivery, ping or flush in rounds 17-42 and 68-97), and
# round 63, the most flushed sends (42)
FRONTIER_IDLE_CALL = 31
FRONTIER_FLUSH_CALL = 64

TPU_LINES = {"fused_sweep": 121, "deliver_sweep": 75, "frontier_sweep": 139,
             "retire_reduce": 178, "retire_scan": 161, "latency_hist": 203,
             "slot_frontier": 225, "ring_apply": 246}
SOURCES = {"fused_sweep": "fused_sweep.cu",
           "deliver_sweep": "deliver_sweep.cu",
           "frontier_sweep": "frontier_sweep.cu",
           "retire_reduce": "retire_reduce.cu",
           # retire_scan is retire_reduce.cu with its record outputs off
           "retire_scan": "retire_reduce.cu",
           "latency_hist": "latency_hist.cu",
           "slot_frontier": "slot_frontier.cu",
           "ring_apply": "ring_apply.cu"}


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


def parity_live_spec(case, device, ops_out, engine="windowed"):
    from repro_torch.api import (LiveSpec, MetricsSpec, ObsSpec, RunSpec,
                                 TopologySpec, WindowSpec)
    return RunSpec(
        protocol="pc", mode="live", engine=engine, n=1024, seed=4,
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


# --------------------------------------------------------------------- #
# Phases 8-12: the sharded engine
# --------------------------------------------------------------------- #
SCALE_N = 1 << 20
# BENCH_scale.json: the counts the exact engine must reproduce
SCALE_COUNTS = dict(rounds=166, sends=2_147_483_648, deliveries=536_870_912,
                    peak_live=116, mean_latency_rounds=9.877)


def sharded_churn_spec(engine: str, device=None):
    """Phase 4's Fig. 7 churn configuration (benchmarks/bench_fig7.py,
    delay 3) on a streaming engine: one rank, window M_total = 140
    columns, the full delivered matrix, the oracle."""
    from dataclasses import replace

    from repro_torch.api import MetricsSpec, ObsSpec, ShardSpec, WindowSpec
    base = gated_spec(device=device)
    shard = (ShardSpec(devices=1, profile=True) if engine == "sharded"
             else ShardSpec())
    return replace(base, engine=engine, shard=shard,
                   window=WindowSpec(window=12 + 128, collect="full"),
                   metrics=MetricsSpec(oracle=True), obs=ObsSpec(spans=True))


def scale_spec(scan: str, device=None):
    """BENCH_scale.json's configuration (benchmarks/bench_scale.py) at
    one rank, with the segment spans and the per-segment profile on."""
    from repro_torch.api import (ObsSpec, RunSpec, ShardSpec, TopologySpec,
                                 TrafficSpec, WindowSpec)
    return RunSpec(
        protocol="pc", engine="sharded", n=SCALE_N, seed=0, device=device,
        shard=ShardSpec(devices=1, scan=scan, profile=True),
        topology=TopologySpec(kind="kregular", k=4, max_delay=1),
        traffic=TrafficSpec(kind="poisson", rate=4.0, messages=512),
        window=WindowSpec(window=128, seg_len=16, collect="aggregate"),
        obs=ObsSpec(histograms=False, spans=True))


def _span_ms(rep):
    out = {}
    for ev in rep.obs.spans.events():
        if ev["kind"] == "span":
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur_ns"] / 1e6
    return out


def sharded_churn_phase(torch, np, captured):
    """Phase 8; keeps the inputs of one slot_frontier and one ring_apply
    call (slot 1 of the round after the last churn round) in
    ``captured``."""
    from repro_torch.api import build_scenario, run
    from repro_torch.core.vecsim import kernels as kx
    spec = sharded_churn_spec("sharded")
    scn = build_scenario(spec)
    k = scn.k
    call = k * (int(scn.add_round[-1]) + 1) + 2
    store, undo = _capture(torch, _shard_ops(),
                           {"slot_frontier": call, "ring_apply": call})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kx.reset_launches()
    try:
        t0 = time.perf_counter()
        rep = run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = dict(kx.LAUNCHES)
    captured["churn"] = store
    res = rep.result
    assert rep.engine == "sharded" and rep.device.startswith(CARD)
    assert res.n_devices == 1 and res.scan == "on"
    assert rep.delivered_frac == 1.0, rep.delivered_frac
    assert rep.oracle.ok, rep.oracle.summary()
    assert res.fast_segments == 0 and res.generic_segments == res.segments
    world = res.n_devices
    assert launches["slot_frontier"] == k * rep.rounds, (launches, k)
    assert launches["ring_apply"] == k * rep.rounds * world, launches
    assert launches["deliver_sweep"] == rep.rounds, launches
    assert launches["latency_hist"] == res.app_sweeps > 0, launches
    assert launches["retire_reduce"] >= 1, launches
    assert launches["fused_sweep"] == launches["frontier_sweep"] == 0
    # the windowed engine on the card, same scenario: byte-identical
    win = run(sharded_churn_spec("windowed"))
    assert win.engine == "windowed"
    np.testing.assert_array_equal(res.delivered, win.result.delivered)
    np.testing.assert_array_equal(res.series, win.result.series)
    assert res.stats == win.result.stats
    for key in ("deliv_count", "deliv_round_sum", "bcast_done", "expired"):
        np.testing.assert_array_equal(getattr(res, key),
                                      getattr(win.result, key), key)
    emit("sharded_churn", n=rep.n, k=k, window=rep.window,
         messages=rep.m_app, adds=scn.n_adds, rounds=rep.rounds,
         segments=res.segments, run_wall_seconds=wall,
         engine_wall_seconds=rep.wall_seconds,
         windowed_engine_wall_seconds=win.wall_seconds,
         delivered_frac=rep.delivered_frac,
         mean_latency_rounds=rep.mean_latency, pongs=rep.extras["pongs"],
         oracle=rep.oracle.summary(), identical_to_windowed=True,
         profile={key: rep.extras["profile_" + key] for key in (
             "stage_s", "dispatch_s", "block_s", "retire_s")},
         span_host_ms=_span_ms(rep),
         windowed_span_host_ms=_span_ms(win),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={name: launches[name] for name in (
             "slot_frontier", "ring_apply", "deliver_sweep",
             "retire_reduce", "latency_hist")})
    return {name: launches[name] for name in ("slot_frontier", "ring_apply",
                                              "deliver_sweep")}


def _scale_run(torch, spec):
    from dataclasses import replace

    from repro_torch.api import build_scenario, run
    from repro_torch.core.vecsim import kernels as kx
    t0 = time.perf_counter()
    scn = build_scenario(spec)
    build_s = time.perf_counter() - t0
    spec = replace(spec, scenario=scn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kx.reset_launches()
    t0 = time.perf_counter()
    rep = run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rep, dict(kx.LAUNCHES), build_s, wall


def _scale_emit(torch, phase, rep, launches, build_s, wall):
    res = rep.result
    c = SCALE_COUNTS
    assert rep.engine == "sharded" and res.n_devices == 1
    assert rep.n == SCALE_N
    assert rep.delivered_frac == 1.0, rep.delivered_frac
    assert int(res.expired.sum()) == 0
    assert rep.rounds == c["rounds"], rep.rounds
    assert rep.stats.sent_messages == c["sends"], rep.stats
    assert rep.stats.deliveries == c["deliveries"], rep.stats
    assert res.peak_live == c["peak_live"], res.peak_live
    assert round(rep.mean_latency, 3) == c["mean_latency_rounds"], \
        rep.mean_latency
    # steady state: every segment after the first
    prof = res.seg_profile
    seg_s = [p["stage_s"] + p["dispatch_s"] + p["block_s"] + p["retire_s"]
             for p in prof]
    steady_sends = int(sum(res.series[p["lo"]:p["hi"], 1:4].sum()
                           for p in prof[1:]))
    emit(phase, n=rep.n, k=4, window=rep.window, seg_len=16,
         messages=rep.m_app, rounds=rep.rounds, scan=res.scan,
         segments=res.segments, fast_segments=res.fast_segments,
         generic_segments=res.generic_segments,
         scenario_build_seconds=build_s, run_wall_seconds=wall,
         engine_wall_seconds=rep.wall_seconds,
         sends=rep.stats.sent_messages,
         sends_per_sec=rep.stats.sent_messages / rep.wall_seconds,
         steady_sends=steady_sends, steady_seconds=sum(seg_s[1:]),
         steady_sends_per_sec=steady_sends / sum(seg_s[1:]),
         first_segment_seconds=seg_s[0],
         deliveries=rep.stats.deliveries, delivered_frac=rep.delivered_frac,
         mean_latency_rounds=rep.mean_latency, peak_live=res.peak_live,
         expired=int(res.expired.sum()),
         profile={key: rep.extras["profile_" + key] for key in (
             "stage_s", "dispatch_s", "block_s", "retire_s")},
         span_host_ms=_span_ms(rep),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches={name: launches[name] for name in (
             "slot_frontier", "ring_apply", "deliver_sweep", "retire_reduce",
             "latency_hist")})


def scale_phase(torch):
    """Phase 9: returns the report for phase 10's comparison."""
    rep, launches, build_s, wall = _scale_run(torch, scale_spec("auto"))
    res = rep.result
    assert res.scan == "on" and res.fast_segments == res.segments
    assert launches["slot_frontier"] == launches["ring_apply"] == 0
    assert launches["retire_reduce"] >= 1
    _scale_emit(torch, "scale", rep, launches, build_s, wall)
    return rep


def scale_scan_off_phase(torch, np, scale, captured):
    """Phase 10: keeps the inputs of slot 1's slot_frontier and
    ring_apply calls of round 40, and of round 40's deliver_sweep call,
    in ``captured``."""
    call = 4 * 40 + 2
    store, undo = _capture(
        torch, {**_shard_ops(), "deliver_sweep": _ops()["deliver_sweep"]},
        {"slot_frontier": call, "ring_apply": call, "deliver_sweep": 40 + 1})
    try:
        rep, launches, build_s, wall = _scale_run(torch, scale_spec("off"))
    finally:
        undo()
    captured["scale"] = store
    res, ref = rep.result, scale.result
    assert res.scan == "off" and res.fast_segments == 0
    assert launches["slot_frontier"] == 4 * rep.rounds, launches
    assert launches["ring_apply"] == 4 * rep.rounds, launches
    assert launches["deliver_sweep"] == rep.rounds, launches
    assert launches["retire_reduce"] >= 1, launches
    np.testing.assert_array_equal(res.series, ref.series)
    assert res.stats == ref.stats
    for key in ("deliv_count", "deliv_round_sum", "bcast_done", "expired"):
        np.testing.assert_array_equal(getattr(res, key), getattr(ref, key),
                                      key)
    assert (res.peak_live, res.lat_sum, res.lat_cnt) == \
        (ref.peak_live, ref.lat_sum, ref.lat_cnt)
    _scale_emit(torch, "scale_scan_off", rep, launches, build_s, wall)
    return {name: launches[name] for name in ("slot_frontier", "ring_apply",
                                              "deliver_sweep")}


def check_shard_small(torch, np, dev, calls):
    """slot_frontier with gating off on phase 2's random inputs, and
    ring_apply at offset 0, on an all-INF plane and on targets that
    mostly coincide (phase 2 ran both with gating on and at a second
    shard's offset)."""
    rng = np.random.default_rng(20262)
    cases = 0
    for n, w in ((16, 9), (24, 7), (8, 1), (12, 11), (100, 77), (64, 128),
                 (600_000, 3)):
        inp = _random_inputs(torch, np, rng, n, w, 3, dev)
        variants = [dict(gating=False), dict(off=0, tgt=inp["tgt"] // 2),
                    dict(vals=torch.full_like(inp["vals"], INF)),
                    dict(tgt=torch.from_numpy(rng.integers(
                        n, n + 3, n).astype(np.int32)).to(dev))]
        for var in variants:
            case = dict(inp, **var)
            for name, (kernel, plain, names, inplace, *_) in calls.items():
                got = _call(torch, kernel, names, case, inplace)
                want = plain(*[case[k] for k in names])
                err = _max_err(torch, got, want)
                if err:
                    raise AssertionError(
                        f"{name} differs from its plain version on "
                        f"({n}, {w}) with {sorted(var)}: max |err| {err}")
            cases += 1
    torch.cuda.synchronize()
    emit("kernels_shard_small", cases=cases, kernels=sorted(calls),
         variants=["gating off", "offset 0", "all-INF vals",
                   "coinciding targets"], max_abs_err=0)
    check_ring_small(torch, dev, calls["ring_apply"])


# ring_apply's word walk: whole 4-cell words in a row (W % 4 == 0), words
# across two rows with a scalar head and tail (odd W), one cell a row
RING_WIDTHS = (1, 3, 4, 5, 128, 140, 141)
# rows of the cases: a few units with a ragged last one, and grids of
# many units a warp
RING_ROWS = (37, 4_099, 600_000)


def _ring_case(torch, gen, dev, n, w, off, variant):
    """ring_apply's inputs for one variant, made on the card from
    ``gen``: sent values in [2, 40) and INF, dest in [0, 40) and INF."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def half_inf(x):
        keep = torch.rand(x.shape, generator=gen, device=dev) < 0.5
        return torch.where(keep, x, torch.full_like(x, INF))
    vals = half_inf(ints(2, 40, (n, w)))
    dest = half_inf(ints(0, 40, (n, w)))
    tgt = ints(0, 2 * n, (n,))          # about half owned at either offset
    if variant == "duplicate":          # every row on one of 3 targets
        tgt = off + ints(0, 3, (n,))
    elif variant == "dropped":          # -1, below off and past off + n
        tgt = ints(-n, 3 * n, (n,))
        tgt[::5] = -1
    elif variant == "all-foreign":
        tgt = off + n + ints(0, n, (n,))
    elif variant == "all-INF":
        vals.fill_(INF)
    elif variant == "dest-lower":       # every sent value already beaten
        dest.fill_(1)
    elif variant == "unaligned":        # vals off a 16-byte boundary
        vals = torch.cat([vals.new_full((1,), INF), vals.reshape(-1)])[1:]
        vals = vals.view(n, w)
    return dict(dest=dest, vals=vals, tgt=tgt, off=off)


RING_VARIANTS = ("random", "duplicate", "dropped", "all-foreign", "all-INF",
                 "dest-lower", "unaligned")


def check_ring_small(torch, dev, call):
    """ring_apply against its plain version, byte for byte, on every
    width of RING_WIDTHS, at offsets 0 and n, for each of RING_VARIANTS,
    at 37 and 4,099 rows, and at 600,000 rows for W of 3, 140 and 141."""
    kernel, plain, names, *_ = call
    gen = torch.Generator(device=dev)
    gen.manual_seed(20264)
    cases = 0
    for w in RING_WIDTHS:
        for n in RING_ROWS:
            if n == RING_ROWS[-1] and w not in (3, 140, 141):
                continue
            for off in (0, n):
                for variant in RING_VARIANTS:
                    case = _ring_case(torch, gen, dev, n, w, off, variant)
                    # the kernel's dest: a copy, off a 16-byte boundary
                    # too in the unaligned variant
                    lead = 2 if variant == "unaligned" else 0
                    dest = torch.empty(n * w + lead, dtype=torch.int32,
                                       device=dev)[lead:].view(n, w)
                    dest.copy_(case["dest"])
                    got = kernel(dest, case["vals"], case["tgt"], off)
                    want = plain(*[case[k] for k in names])
                    err = _max_err(torch, got, want)
                    if err:
                        raise AssertionError(
                            f"ring_apply differs from its plain version on "
                            f"({n}, {w}), off {off}, {variant}: max |err| "
                            f"{err}")
                    cases += 1
    torch.cuda.synchronize()
    emit("ring_apply_small", cases=cases, widths=list(RING_WIDTHS),
         rows=list(RING_ROWS), offsets=["0", "n"],
         variants=list(RING_VARIANTS), max_abs_err=0)


def check_shard_main_path(torch, calls, captured):
    """The sharded kernels on the inputs phases 8 (N = 50,000, W = 140,
    K = 17) and 10 (N = 2^20, W = 128, K = 4) gave them; the churn
    shape is the kernels line's entry, the scale shape rides in it."""
    entries = []
    for name, call in calls.items():
        entry = _entry(torch, name, call, captured["churn"].pop(name))
        entry["at_scale"] = {
            key: v for key, v in _entry(
                torch, name, call, captured["scale"].pop(name)).items()
            if key in _AT_SCALE_KEYS}
        entries.append(entry)
    torch.cuda.empty_cache()
    return entries


_AT_SCALE_KEYS = ("shape", "ms", "ms_repeats", "wrapper_ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms", "max_abs_err",
                  "flushed", "round")


def _deliver_at_scale(torch, captured):
    """deliver_sweep on the inputs of round 40 of phase 10 (N = 2^20, W =
    128): held, timed and bounded; rides in its churn-shape entry."""
    inp = captured["scale"].pop("deliver_sweep")
    entry = _entry(torch, "deliver_sweep", _ops()["deliver_sweep"], inp)
    entry["round"] = int(inp["t"])
    torch.cuda.empty_cache()
    return {key: v for key, v in entry.items() if key in _AT_SCALE_KEYS}


# deliver_sweep's row walk: whole 4-cell words in a row (W % 4 == 0), words
# across rows with a scalar head and tail (odd W), one cell a row, a row
# of two pieces (W > 512)
DELIVER_WIDTHS = (1, 3, 4, 5, 127, 128, 140, 141, 513)
DELIVER_ROWS = (37, 4_099)
DELIVER_VARIANTS = ("random", "crashed", "all-delivered", "all-undelivered",
                    "arr-t-on-delivered", "shifted", "unaligned")


def _deliver_case(torch, gen, dev, n, w, variant):
    """deliver_sweep's inputs for one variant, made on the card from
    ``gen``: arrivals at t on 30% of the cells, 40% delivered earlier and
    10% at t, 10% of the rows crashed (half in the crashed variant)."""
    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    t = 20
    arr = torch.where(rand((n, w)) < 0.5, ints(0, 25, (n, w)),
                      torch.full((n, w), INF, dtype=torch.int32, device=dev))
    arr[rand((n, w)) < 0.3] = t
    delivered = torch.where(rand((n, w)) < 0.4, ints(0, 20, (n, w)),
                            torch.full_like(arr, -1))
    delivered[rand((n, w)) < 0.1] = t
    crashed = rand(n) < (0.5 if variant == "crashed" else 0.1)
    is_app = rand(w) < 0.7
    if variant == "all-delivered":
        delivered = ints(0, 20, (n, w))
    elif variant == "all-undelivered":
        delivered.fill_(-1)
    elif variant == "arr-t-on-delivered":
        arr[delivered >= 0] = t
    return dict(arr=arr, delivered=delivered, crashed=crashed, is_app=is_app,
                t=t)


def _offset(x, lead):
    """A copy of ``x`` that starts ``lead`` elements past a 16-byte
    boundary."""
    buf = x.new_empty(x.numel() + lead)
    return buf[lead:].view(x.shape).copy_(x)


def check_deliver_small(torch, dev):
    """deliver_sweep against its plain version, byte for byte, on every
    width of DELIVER_WIDTHS at 37 and 4,099 rows, for each of
    DELIVER_VARIANTS ("shifted": delivered and arr two cells past a
    16-byte boundary, "unaligned": delivered, arr and is_app off their
    boundaries by different amounts, so the general walk runs, with arr
    read cell by cell in the second), and at 600,000 rows for W of 3,
    128 and 140."""
    kernel, plain, names, inplace = _ops()["deliver_sweep"][:4]
    gen = torch.Generator(device=dev)
    gen.manual_seed(20265)
    cases = 0
    shapes = [(n, w) for w in DELIVER_WIDTHS for n in DELIVER_ROWS]
    shapes += [(600_000, w) for w in (3, 128, 140)]
    for n, w in shapes:
        for variant in DELIVER_VARIANTS:
            case = _deliver_case(torch, gen, dev, n, w, variant)
            want = plain(*[case[k] for k in names])
            if variant in ("shifted", "unaligned"):
                lead = (2, 2, 0) if variant == "shifted" else (3, 1, 1)
                case = dict(case, delivered=_offset(case["delivered"],
                                                    lead[0]),
                            arr=_offset(case["arr"], lead[1]),
                            is_app=_offset(case["is_app"], lead[2]))
                got = kernel(*[case[k] for k in names])
            else:
                got = _call(torch, kernel, names, case, inplace)
            err = _max_err(torch, got, want)
            if err:
                raise AssertionError(
                    f"deliver_sweep differs from its plain version on "
                    f"({n}, {w}), {variant}: max |err| {err}")
            cases += 1
    torch.cuda.synchronize()
    emit("deliver_sweep_small", cases=cases, widths=list(DELIVER_WIDTHS),
         rows=list(DELIVER_ROWS) + [600_000],
         variants=list(DELIVER_VARIANTS), max_abs_err=0)


# frontier_sweep's walk: the widths of deliver_sweep's, every K in slot
# groups of 32 (K of 33 and 40: two groups), and the cases of its CPU
# mirror (tests/test_torch_frontier_vec.py)
FRONTIER_KS = (1, 3, 17, 32, 33, 40)
FRONTIER_VARIANTS = ("gate-equal-d", "gate-above-t", "gate-minus-1",
                     "now-app-ping", "do-and-fwd", "bad-targets", "all-INF",
                     "arr-lower", "all-flushing", "none-flushing", "shifted")


def _frontier_case(torch, gen, dev, n, w, k, variant):
    """frontier_sweep's inputs for one variant, made on the card from
    ``gen``: 40% of the cells delivered before t, 10% at t, the rest
    undelivered; gates from -1 to t + 2 on 40% of the slots; 30% of the
    slots flushing, 60% forward-eligible; arr 40% finite."""
    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    t = 12
    minus = torch.full((n, w), -1, dtype=torch.int32, device=dev)
    delivered = torch.where(rand((n, w)) < 0.4, ints(0, t, (n, w)), minus)
    delivered[rand((n, w)) < 0.1] = t
    arr = torch.where(rand((n, w)) < 0.4, ints(t + 1, t + 8, (n, w)),
                      torch.full_like(minus, INF))
    adj = ints(0, n, (n, k))
    delay = ints(1, 5, (n, k))
    gate = torch.where(rand((n, k)) < 0.4, ints(-1, t + 3, (n, k)),
                       torch.full_like(adj, -1))
    do = rand((n, k)) < 0.3
    fwd_ok = rand((n, k)) < 0.6
    is_app = rand(w) < 0.5
    if variant == "gate-equal-d":
        # each flushing slot's gate equal to a delivered value of its row
        rows = torch.arange(n, device=dev)[:, None]
        gate = delivered[rows, ints(0, w, (n, k)).long()].contiguous()
        do = rand((n, k)) < 0.5
    elif variant == "gate-above-t":
        gate = ints(t + 1, t + 5, (n, k))
        do.fill_(True)
    elif variant == "gate-minus-1":
        gate.fill_(-1)
    elif variant == "now-app-ping":
        delivered[rand((n, w)) < 0.5] = t
        is_app[::2] = True
        is_app[1::2] = False
    elif variant == "do-and-fwd":
        do = rand((n, k)) < 0.7
        fwd_ok = do | (rand((n, k)) < 0.3)
    elif variant == "bad-targets":
        # -1, N and past it (dropped), the sender's own row, duplicates
        pick = rand((n, k))
        own = torch.arange(n, device=dev, dtype=torch.int32)[:, None]
        adj = torch.where(pick < 0.2, -1, adj)
        adj = torch.where((pick >= 0.2) & (pick < 0.3), n, adj)
        adj = torch.where((pick >= 0.3) & (pick < 0.4), n + 5, adj)
        adj = torch.where((pick >= 0.4) & (pick < 0.5), own.expand(n, k),
                          adj).to(torch.int32)
        adj[:, -1] = adj[:, 0]
        adj = adj.contiguous()
        do = rand((n, k)) < 0.5
    elif variant == "all-INF":
        arr.fill_(INF)
    elif variant == "arr-lower":
        arr = ints(0, t + 2, (n, w))
    elif variant == "all-flushing":
        do.fill_(True)
    elif variant == "none-flushing":
        do.fill_(False)
    return dict(arr=arr, delivered=delivered, adj=adj, delay=delay, gate=gate,
                do=do, fwd_ok=fwd_ok, is_app=is_app, t=t)


def check_frontier_small(torch, dev):
    """frontier_sweep against its plain version, byte for byte (arr and
    the flushed count), on every width of DELIVER_WIDTHS at 37 and 4,099
    rows: random inputs at every K of FRONTIER_KS, then each of
    FRONTIER_VARIANTS with K in rotation ("shifted": delivered three
    cells past a 16-byte boundary); and at 600,000 rows for W of 3, 128
    and 140 at K = 17, random and shifted."""
    kernel, plain, names, inplace = _ops()["frontier_sweep"][:4]
    gen = torch.Generator(device=dev)
    gen.manual_seed(20267)
    cases = []
    for i, w in enumerate(DELIVER_WIDTHS):
        for n in DELIVER_ROWS:
            cases += [(n, w, k, "random") for k in FRONTIER_KS]
            cases += [(n, w, FRONTIER_KS[(i + j) % len(FRONTIER_KS)], v)
                      for j, v in enumerate(FRONTIER_VARIANTS)]
    cases += [(600_000, w, 17, v) for w in (3, 128, 140)
              for v in ("random", "shifted")]
    flushed = 0
    for n, w, k, variant in cases:
        case = _frontier_case(torch, gen, dev, n, w, k, variant)
        want = plain(*[case[key] for key in names])
        if variant == "shifted":
            case = dict(case, delivered=_offset(case["delivered"], 3))
        got = _call(torch, kernel, names, case, inplace)
        err = _max_err(torch, got, want)
        if err:
            raise AssertionError(
                f"frontier_sweep differs from its plain version on ({n}, "
                f"{w}), K = {k}, {variant}: max |err| {err}")
        flushed += int(want[1])
    torch.cuda.synchronize()
    emit("frontier_sweep_small", cases=len(cases),
         widths=list(DELIVER_WIDTHS), rows=list(DELIVER_ROWS) + [600_000],
         ks=list(FRONTIER_KS), variants=["random"] + list(FRONTIER_VARIANTS),
         flushed=flushed, max_abs_err=0)


def _port_builders():
    """The scenario builders of tests/vecsim_cases.py, from the port."""
    from repro_torch.core.vecsim import scenario as sc
    return {
        "static": lambda seed, n: sc.static_scenario(seed, n),
        "link_add": lambda seed, n: sc.link_add_scenario(seed, n),
        "churn": lambda seed, n: sc.churn_scenario(seed, n),
        "crash": lambda seed, n: sc.crash_scenario(seed, n),
        "waves": lambda seed, n: sc.churn_wave_scenario(seed, n, waves=2),
        "partition": lambda seed, n: sc.partition_heal_scenario(
            seed, max(n, 12), traffic_during_partition=bool(seed % 2)),
        "sustained_kreg": lambda seed, n: sc.sustained_scenario(
            seed, n, k=5, rate=1.0 + (seed % 3), messages=24,
            topology="kregular", max_delay=2),
        "sustained_sw": lambda seed, n: sc.sustained_scenario(
            seed, n, k=5, rate=2.0, messages=24, topology="smallworld",
            traffic="bursty", max_delay=2),
    }


def sharded_parity_phase(np):
    """Phase 12: the sharded engine on the card and on the CPU."""
    from repro_torch.api import run
    from repro_torch.core.vecsim.shard import execute_sharded
    t0 = time.perf_counter()
    checked = 0
    for name, build in _port_builders().items():
        scn = build(5, 256)
        for scan in ("on", "off"):
            a, b = (execute_sharded(scn, scn.m_total, device=d, seg_len=16,
                                    collect="full", scan=scan)
                    for d in (None, "cpu"))
            assert a.device.startswith(CARD) and b.device == "cpu"
            assert a.stats == b.stats, (name, scan)
            for key in ("delivered", "series", "deliv_count",
                        "deliv_round_sum", "bcast_done", "expired"):
                np.testing.assert_array_equal(getattr(a, key),
                                              getattr(b, key),
                                              f"{name}/{scan}/{key}")
            for key in a.state:
                np.testing.assert_array_equal(a.state[key], b.state[key],
                                              f"{name}/{scan}/{key}")
            assert (a.fast_segments, a.peak_live) == \
                (b.fast_segments, b.peak_live)
            checked += 1
    emit("sharded_parity", case="builders_n256", runs=checked,
         identical=True, seconds=time.perf_counter() - t0)
    import tempfile
    t0 = time.perf_counter()
    case = dict(admission="defer", window=48)
    with tempfile.TemporaryDirectory() as tmp:
        gpu, cpu = (run(parity_live_spec(case, d, os.path.join(
            tmp, f"ops.{d}.jsonl"), engine="sharded")) for d in (None, "cpu"))
    assert gpu.engine == cpu.engine == "sharded"
    assert gpu.device.startswith(CARD) and cpu.device == "cpu"
    da, db = gpu.live.to_dict(), cpu.live.to_dict()
    for key in ("wall_seconds", "requests_per_sec"):
        da.pop(key)
        db.pop(key)
    assert da == db and gpu.live.ticks == cpu.live.ticks
    assert gpu.oracle.ok and cpu.oracle.ok
    assert gpu.live.backpressure_ticks > 0
    a, b = gpu.result, cpu.result
    assert a.stats == b.stats
    for key in ("delivered", "series", "deliv_count", "deliv_round_sum",
                "bcast_done", "expired"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), key)
    np.testing.assert_array_equal(gpu.obs.latency_hist, cpu.obs.latency_hist)
    assert gpu.obs.flight.export() == cpu.obs.flight.export()
    assert gpu.extras["audit_violations"] == 0
    emit("sharded_parity", case="live_bursty_defer_n1024", rounds=gpu.rounds,
         ticks=gpu.live.ticks_run,
         backpressure_ticks=gpu.live.backpressure_ticks,
         provenance_records=len(gpu.obs.flight.completed),
         audit_pairs_checked=gpu.extras["audit_pairs_checked"],
         identical=True, seconds=time.perf_counter() - t0)


def ranks_phase(torch, np, most: int):
    """The sharded configurations over 2 and ``most`` ranks (NCCL, one
    card a rank, started by the front door) against one rank in this
    process: series, NetStats and per-message aggregates byte-identical,
    and the delivered matrix and state where collected."""
    from dataclasses import replace

    from repro_torch.api import run
    from repro_torch.core.vecsim.shard.mesh import require_cards
    require_cards(most, torch.device("cuda"))
    emit("ranks", cuda_device_count=torch.cuda.device_count())
    churn = sharded_churn_spec("sharded")
    # the delivered matrix is compared whole, so the oracle adds nothing
    specs = {"sharded_churn": replace(churn, metrics=replace(
                 churn.metrics, oracle=False)),
             "scale": scale_spec("auto"), "scale_scan_off": scale_spec("off")}
    for name, spec in specs.items():
        one = run(spec)
        for world in sorted({2, most}):
            t0 = time.perf_counter()
            many = run(replace(spec, shard=replace(spec.shard,
                                                   devices=world)))
            wall = time.perf_counter() - t0
            a, b = one.result, many.result
            assert many.engine == "sharded" and b.n_devices == world
            assert many.device.startswith(CARD)
            np.testing.assert_array_equal(a.series, b.series, name)
            assert a.stats == b.stats, name
            for key in ("deliv_count", "deliv_round_sum", "bcast_done",
                        "expired"):
                np.testing.assert_array_equal(getattr(a, key),
                                              getattr(b, key), key)
            if a.delivered is not None:
                np.testing.assert_array_equal(a.delivered, b.delivered)
                for key in a.state:
                    np.testing.assert_array_equal(a.state[key],
                                                  b.state[key], key)
            emit("ranks", case=name, world=world, identical_to_one_rank=True,
                 rounds=many.rounds, engine_wall_seconds=many.wall_seconds,
                 one_rank_engine_wall_seconds=one.wall_seconds,
                 launch_and_run_seconds=wall,
                 fast_segments=b.fast_segments,
                 generic_segments=b.generic_segments,
                 profile={key: many.extras["profile_" + key] for key in (
                     "stage_s", "dispatch_s", "block_s", "retire_s")},
                 delivered_frac=many.delivered_frac)



# --------------------------------------------------------------------- #
# Phases 13-16: the LM substrate
# --------------------------------------------------------------------- #
LM_KSRC = "src/repro_torch/kernels/csrc"
LM_REPLACES = {
    "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:24",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:26",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:30"}
# H100 SXM data-sheet peak of the tensor cores, dense bf16: the LM
# kernels' operations are counted against it
BF16_FLOPS_PER_S = 989e12
# tests/test_kernels.py's tolerances, by the inputs' type
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LM_FAMILIES = ("yi-6b", "mamba2-2.7b", "recurrentgemma-9b")
# the two serving phases: arch -> (its kernel, the layers that launch it
# in a prefill, the prompt lengths' range)
LM_SERVE = {"recurrentgemma-9b": ("rglru_scan", 26, 512, 2560),
            "mamba2-2.7b": ("ssd_scan", 64, 512, 2048)}
# flash attention at a yi-6b train_4k-like shape
FLASH_TRAIN_SHAPE = dict(b=1, h=32, kv=4, sq=4096, skv=4096, d=128)
LM_LAUNCHER_ARGS = ["--arch", "recurrentgemma-9b"]


def _lm_ops():
    """name -> (wrapper, plain version, maker of a bare launch), each
    taking the input dict; the maker allocates the outputs (outside any
    timed interval) and returns a closure that launches into them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, launch_flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru_scan.ops import (launch_rglru_scan,
                                                    rglru_scan)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.ssd_scan.ops import (launch_ssd_scan,
                                                  ssd_chunk_scan)
    from repro_torch.kernels.ssd_scan.ref import (chunk_len,
                                                  ssd_chunk_scan_ref)

    def rglru_bare(i):
        h = torch.empty(i["a"].shape, dtype=torch.float32,
                        device=i["a"].device)
        return lambda: launch_rglru_scan(i["a"], i["bx"], i["h0"], h)

    def ssd_bare(i):
        x, al, bm, cm = i["xbar"], i["a_log"], i["Bm"], i["Cm"]
        b, s, h, p = x.shape
        q = chunk_len(s, i["chunk"])
        pad = (-s) % q
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            al = F.pad(al, (0, 0, 0, pad))
            bm, cm = (F.pad(t, (0, 0, 0, pad)) for t in (bm, cm))
        y = torch.empty_like(x)
        hout = torch.empty((b, h, bm.shape[-1], p), dtype=torch.float32,
                           device=x.device)
        return lambda: launch_ssd_scan(x, al, bm, cm, y, hout, q)

    def flash_bare(i):
        o = torch.empty_like(i["q"])
        return lambda: launch_flash_attention(i["q"], i["k"], i["v"], o,
                                              i["causal"], i["k"].shape[2])

    return {
        "rglru_scan": (
            lambda i: rglru_scan(i["a"], i["bx"], i["h0"]),
            lambda i: rglru_scan_ref(i["a"], i["bx"], i["h0"]), rglru_bare),
        "ssd_scan": (
            lambda i: ssd_chunk_scan(i["xbar"], i["a_log"], i["Bm"], i["Cm"],
                                     i["chunk"]),
            lambda i: ssd_chunk_scan_ref(i["xbar"], i["a_log"], i["Bm"],
                                         i["Cm"], chunk=i["chunk"]),
            ssd_bare),
        "flash_attention": (
            lambda i: flash_attention(i["q"], i["k"], i["v"], i["causal"]),
            lambda i: flash_attention_ref(i["q"], i["k"], i["v"],
                                          i["causal"]), flash_bare),
    }


def _lm_dtype(name, inp) -> str:
    first = inp[{"rglru_scan": "a", "ssd_scan": "xbar",
                 "flash_attention": "q"}[name]]
    return str(first.dtype).replace("torch.", "")


def _lm_close(torch, got, want, tol):
    """(max |difference|, every element within ``tol`` absolute plus
    ``tol`` relative and finite) over the outputs."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), (len(got), len(want))
    err, ok = 0.0, True
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (
            g.shape, w.shape, g.dtype, w.dtype)
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        ok &= bool(torch.isfinite(g).all()) and bool(
            (diff <= tol + tol * w.abs()).all())
    return err, ok


def _time_fn(torch, fn, reps, queued=True) -> float:
    """Median CUDA-event time of ``fn()``, after one warm-up call;
    ``queued`` as for ``_time_ms``."""
    fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _lm_bound(np, name, inp):
    """(bound_ms, bound_by, flops, bytes): the larger of the bytes the
    function must move (each input read once, each output written once)
    over 3.35 TB/s and its floating-point operations over 989 TFLOP/s
    (the H100 SXM's dense bf16 tensor-core peak), counted from these
    inputs; the masked-out halves of causal products are not counted."""
    if name == "rglru_scan":
        a = inp["a"]
        b, s, w = a.shape
        nbytes = 2 * a.element_size() * b * s * w + 4 * b * s * w
        nbytes += 4 * b * w if inp["h0"] is not None else 0
        flops = 2 * b * s * w
    elif name == "ssd_scan":
        from repro_torch.kernels.ssd_scan.ref import chunk_len
        x = inp["xbar"]
        b, s, h, p = x.shape
        n = inp["Bm"].shape[-1]
        e = x.element_size()
        q = chunk_len(s, inp["chunk"])
        nc = -(-s // q)
        nbytes = (2 * e * b * s * h * p + 4 * b * s * h + 2 * e * b * s * n
                  + 4 * b * h * n * p)
        tri = q * (q + 1) // 2
        # C B^T and (att) x on the lower triangle, C H and the state
        flops = 2 * b * h * nc * (tri * n + tri * p + 2 * q * n * p)
    else:
        q, k = inp["q"], inp["k"]
        b, h, sq, d = q.shape
        kv, skv = k.shape[1], k.shape[2]
        rows = np.arange(sq, dtype=np.int64)
        pairs = int(np.minimum(rows + 1, skv).sum()) if inp["causal"] \
            else sq * skv
        flops = 4 * b * h * d * pairs
        nbytes = q.element_size() * (2 * b * h * sq * d + 2 * b * kv * skv * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes)


def _lm_random(torch, np, rng, name, dev, dtype, **shape):
    """Random inputs of one LM kernel, made with numpy from ``rng``."""
    dt = getattr(torch, dtype)

    def t(a, dtype=dt):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            dev, dtype)
    if name == "rglru_scan":
        b, s, w = shape["b"], shape["s"], shape["w"]
        if shape.get("near_one"):
            # repro.models.rglru._gates scales the input by sqrt(1 - a^2)
            a = 1 - 1e-4 * rng.random((b, s, w))
            x = rng.standard_normal((b, s, w)) * np.sqrt(1 - a * a)
        else:
            a = 1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
            x = rng.standard_normal((b, s, w)) * 0.2
        return dict(a=t(a), bx=t(x),
                    h0=(t(rng.standard_normal((b, w)) * 0.1, torch.float32)
                        if shape["h0"] else None))
    if name == "ssd_scan":
        b, s, h, p, n = (shape[k] for k in "bshpn")
        return dict(xbar=t(rng.standard_normal((b, s, h, p)) * 0.5),
                    a_log=t(-np.logaddexp(rng.standard_normal((b, s, h)), 0),
                            torch.float32),
                    Bm=t(rng.standard_normal((b, s, n)) * 0.3),
                    Cm=t(rng.standard_normal((b, s, n)) * 0.3),
                    chunk=shape["chunk"])
    b, h, kv, sq, skv, d = (shape[k] for k in ("b", "h", "kv", "sq", "skv",
                                               "d"))
    return dict(q=t(rng.standard_normal((b, h, sq, d))),
                k=t(rng.standard_normal((b, kv, skv, d))),
                v=t(rng.standard_normal((b, kv, skv, d))),
                causal=shape["causal"])


LM_SMALL = {
    "rglru_scan": [dict(b=2, s=37, w=100, h0=True),
                   dict(b=1, s=300, w=96, h0=False),
                   dict(b=3, s=64, w=64, h0=True),
                   dict(b=2, s=256, w=4096, h0=False),
                   dict(b=1, s=1, w=7, h0=True),
                   # the chunked scan's edges (chunks of 16 rows, blocks
                   # of 512 columns): S below, at and one past a chunk,
                   # W not a multiple of 4, one past a block, B of 3, a
                   # chain of 512 chunks, and a within 1e-4 of 1 with x
                   # scaled as the model scales it (a long memory)
                   dict(b=1, s=15, w=12, h0=True),
                   dict(b=1, s=16, w=8, h0=False),
                   dict(b=2, s=17, w=5, h0=True),
                   dict(b=3, s=200, w=513, h0=False),
                   dict(b=1, s=8192, w=4, h0=True),
                   dict(b=1, s=8192, w=64, h0=True, near_one=True)],
    "ssd_scan": [dict(b=2, s=96, h=3, p=16, n=32, chunk=32),
                 dict(b=2, s=100, h=2, p=16, n=32, chunk=32),   # padded
                 dict(b=1, s=5, h=2, p=16, n=16, chunk=16),     # q = S
                 dict(b=1, s=64, h=1, p=8, n=16, chunk=16),
                 # the full-width tile: f32 splits (Q, Q) into row tiles
                 dict(b=1, s=300, h=4, p=64, n=128, chunk=128),
                 # the tensor-core body's edges: P slices of 32 with a
                 # ragged last one (P = 48), H and B not multiples of
                 # anything, q = S < chunk with P = 8, a last chunk of
                 # one step, P and N not multiples of 8 (element copies),
                 # the main path's heads at a short S; and bf16 shapes
                 # the FMA body takes (N > 128, chunk > 128)
                 dict(b=2, s=200, h=3, p=48, n=128, chunk=128),
                 dict(b=1, s=40, h=5, p=8, n=16, chunk=64),
                 dict(b=2, s=64, h=7, p=16, n=32, chunk=32),
                 dict(b=1, s=129, h=2, p=64, n=128, chunk=128),
                 dict(b=1, s=100, h=3, p=12, n=24, chunk=128),
                 dict(b=1, s=200, h=80, p=64, n=128, chunk=128),
                 dict(b=1, s=50, h=2, p=64, n=200, chunk=64),
                 dict(b=1, s=300, h=2, p=32, n=64, chunk=256)],
    "flash_attention": [
        dict(b=1, h=4, kv=4, sq=128, skv=128, d=64, causal=True),
        dict(b=2, h=4, kv=2, sq=200, skv=200, d=64, causal=True),
        dict(b=1, h=8, kv=1, sq=256, skv=256, d=128, causal=True),
        dict(b=2, h=4, kv=2, sq=160, skv=160, d=96, causal=False),
        dict(b=1, h=2, kv=2, sq=64, skv=64, d=32, causal=True),
        dict(b=1, h=2, kv=1, sq=40, skv=40, d=16, causal=True),
        dict(b=1, h=4, kv=2, sq=50, skv=200, d=64, causal=False),
        dict(b=1, h=4, kv=1, sq=200, skv=200, d=256, causal=True),
        # D not a multiple of 16: the FMA variant in bf16 too
        dict(b=1, h=3, kv=1, sq=70, skv=70, d=40, causal=True),
        # H / KV of 16, 4 and 1 packed into a block; S not a multiple of
        # a tile, kv padded past seq_kv; fewer positions than a block; a
        # group wider than a block (two head chunks); q longer than kv
        dict(b=1, h=16, kv=1, sq=100, skv=100, d=256, causal=True),
        dict(b=2, h=16, kv=4, sq=77, skv=77, d=128, causal=True),
        dict(b=1, h=16, kv=16, sq=33, skv=33, d=64, causal=False),
        dict(b=1, h=16, kv=1, sq=5, skv=5, d=128, causal=True),
        dict(b=1, h=80, kv=1, sq=20, skv=20, d=32, causal=True),
        dict(b=1, h=4, kv=1, sq=3, skv=300, d=128, causal=False),
        dict(b=1, h=4, kv=1, sq=130, skv=70, d=64, causal=True)],
}


def check_lm_small(torch, np, dev):
    """Phase 13a: each LM kernel against its plain version on the card on
    small random cases (odd and padded S and W, S below one chunk or
    block, h0 on and off, GQA and MQA, D from 16 to 256, causal and
    full, a kv longer than q), in float32 and bfloat16."""
    from repro_torch.kernels import LAUNCHES
    calls = _lm_ops()
    rng = np.random.default_rng(20270)
    errs = {}
    cases = 0
    bodies = {}
    for name, shapes in LM_SMALL.items():
        kernel, plain, _ = calls[name]
        for shape in shapes:
            for dtype in ("float32", "bfloat16"):
                inp = _lm_random(torch, np, rng, name, dev, dtype, **shape)
                if name == "ssd_scan":
                    body = _ssd_body(inp)
                    bodies[f"{body} {dtype}"] = bodies.get(
                        f"{body} {dtype}", 0) + 1
                before = LAUNCHES[name]
                got = kernel(inp)
                assert LAUNCHES[name] == before + 1, name
                err, ok = _lm_close(torch, got, plain(inp), LM_TOL[dtype])
                if not ok:
                    raise AssertionError(
                        f"{name} differs from its plain version on "
                        f"{shape} {dtype}: max |err| {err}")
                errs[name] = max(errs.get(name, 0.0), err)
                cases += 1
    torch.cuda.synchronize()
    assert bodies.get("mma bfloat16") and bodies.get("fma bfloat16") and \
        not bodies.get("mma float32"), bodies
    emit("lm_kernels_small", cases=cases, kernels=sorted(calls),
         max_abs_err=errs, tolerance=LM_TOL, ssd_scan_bodies=bodies)


def _ssd_body(inp) -> str:
    """The body ssd_scan runs on these inputs: "mma" or "fma"."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_body
    from repro_torch.kernels.ssd_scan.ref import chunk_len
    s = inp["xbar"].shape[1]
    return ssd_scan_body(chunk_len(s, inp["chunk"]), inp["Bm"].shape[-1],
                         inp["xbar"].dtype)


def _lm_entry(torch, np, name, inp, note=None):
    """The kernels-line entry of ``name`` on the inputs ``inp``: held
    against its plain version, timed (bare launch, wrapper, plain) and
    bounded; flash also against scaled_dot_product_attention."""
    kernel, plain, bare = _lm_ops()[name]
    dtype = _lm_dtype(name, inp)
    got = kernel(inp)
    want = plain(inp)
    err, ok = _lm_close(torch, got, want, LM_TOL[dtype])
    if not ok:
        raise AssertionError(f"{name} differs from its plain version at "
                             f"the main-path shape: max |err| {err}")
    bound_ms, bound_by, flops, nbytes = _lm_bound(np, name, inp)
    launch = bare(inp)
    ms = _time_fn(torch, launch, 20)
    wrapper_ms = _time_fn(torch, lambda: kernel(inp), 20, queued=False)
    plain_ms = _time_fn(torch, lambda: plain(inp), 5, queued=False)
    ms2 = _time_fn(torch, launch, 20)
    first = inp[{"rglru_scan": "a", "ssd_scan": "xbar",
                 "flash_attention": "q"}[name]]
    entry = dict(
        name=name, route="cuda", source=f"{LM_KSRC}/{name}.cu",
        replaces=LM_REPLACES[name], launches=None, max_abs_err=err,
        ms=min(ms, ms2), plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, shape=list(first.shape),
        dtype=dtype, tolerance=LM_TOL[dtype], flops=flops, bytes=nbytes,
        ms_repeats=[ms, ms2], wrapper_ms=wrapper_ms)
    if name == "flash_attention":
        entry["kv_shape"] = list(inp["k"].shape)
        entry.update(_library_flash(torch, inp, got))
    if name == "ssd_scan":
        entry["n"] = int(inp["Bm"].shape[-1])
        entry["chunk"] = int(inp["chunk"])
        entry["body"] = _ssd_body(inp)
        entry.update(_ssd_f64(torch, inp, got, want))
    if note:
        entry["note"] = note
    return entry


def _ssd_f64(torch, inp, got, want):
    """The kernel's and the plain version's largest differences from the
    plain version evaluated in float64 on the same inputs, absolute and
    as a fraction of the tolerance (|diff| / (tol + tol |f64|), 1 at its
    edge); the kernel's must be within the tolerance of its type."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_scan_ref
    truth = ssd_chunk_scan_ref(*(inp[k].double() for k in (
        "xbar", "a_log", "Bm", "Cm")), chunk=inp["chunk"])
    tol = LM_TOL[_lm_dtype("ssd_scan", inp)]
    out = {}
    for who, res in (("kernel", got), ("plain", want)):
        res = tuple(r.double() for r in res)
        err, ok = _lm_close(torch, res, truth, tol)
        out[f"{who}_f64_max_abs_err"] = err
        out[f"{who}_f64_tol_frac"] = max(
            float(((r - w).abs() / (tol + tol * w.abs())).max())
            for r, w in zip(res, truth))
        if who == "kernel" and not ok:
            raise AssertionError(f"ssd_scan is further than {tol} from "
                                 f"a float64 evaluation: {err}")
    return out


def _library_flash(torch, inp, got):
    """``scaled_dot_product_attention`` on the same inputs (one call,
    causal at the start like the kernel, GQA by ``enable_gqa``): its time
    and its largest difference from the kernel's output."""
    import torch.nn.functional as F
    q, k, v, causal = inp["q"], inp["k"], inp["v"], inp["causal"]
    assert q.shape[2] == k.shape[2] or not causal

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    lib = library()
    err, ok = _lm_close(torch, lib, got, LM_TOL[_lm_dtype(
        "flash_attention", inp)])
    if not ok:
        raise AssertionError(f"scaled_dot_product_attention differs from "
                             f"flash_attention: max |err| {err}")
    return dict(library_ms=_time_fn(torch, library, 20),
                library_call="F.scaled_dot_product_attention(is_causal, "
                             "enable_gqa=True)",
                library_max_abs_err=err)


def _lm_prompts(np, cfg, lo, hi, n=8, seed=0):
    """``n`` prompts of random tokens, their lengths drawn in [lo, hi]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32)
            for m in lens]


def lm_serve_phase(torch, np, arch, capture_attention=False):
    """Phases 14 and 15: ``arch`` at full width and depth, random weights
    from a seeded generator on the card, bf16 compute, through
    ``ServingEngine`` (4 slots, max_len 4,096, 8 prompts of seeded random
    lengths and tokens, 16 greedy tokens each).  Gates: every request
    done with 16 tokens, every logit finite, exactly as many launches of
    the arch's kernel in each prefill as it has layers of that kind.
    Returns (launches of the three LM kernels in the
    run, the inputs of the kernel's first call, and — with
    ``capture_attention`` — q, k, v and the output of the first
    attention layer of a separate 2,048-token prefill)."""
    import gc

    import repro_torch.models.layers as layers_mod
    import repro_torch.models.rglru as rglru_mod
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = get_arch(arch)
    kernel, per_prefill, lo, hi = LM_SERVE[arch]
    assert cfg.layer_kinds().count(
        {"rglru_scan": "rec", "ssd_scan": "ssm"}[kernel]) == per_prefill
    prompts = _lm_prompts(np, cfg, lo, hi)
    lens = np.array([len(p) for p in prompts])
    if kernel == "rglru_scan":
        # a prompt past the window (the cache roll), one off the
        # blockwise attention's 512 grid
        assert (lens > cfg.window).any() and (lens % 512).any(), lens
    else:
        assert (lens % cfg.ssm_chunk).any(), lens   # a padded last chunk
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert model.device.type == CARD
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())

    stats = dict(prefill_ms=[], prefill_launches=[], decode_ms=[])
    finite = []
    orig_prefill, orig_decode = model.prefill, model.decode_step

    def prefill(tokens, pad_to=None):
        torch.cuda.synchronize()
        before = LAUNCHES[kernel]
        t = time.perf_counter()
        last, caches = orig_prefill(tokens, pad_to=pad_to)
        torch.cuda.synchronize()
        stats["prefill_ms"].append((time.perf_counter() - t) * 1e3)
        stats["prefill_launches"].append(LAUNCHES[kernel] - before)
        finite.append(torch.isfinite(last).all())
        return last, caches

    def decode_step(token, caches, cur_index):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = orig_decode(token, caches, cur_index)
        torch.cuda.synchronize()
        stats["decode_ms"].append((time.perf_counter() - t) * 1e3)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    model.prefill, model.decode_step = prefill, decode_step
    # keep the inputs of the kernel wrapper's first call in the run
    mod, attr = ((rglru_mod, "rglru_scan") if kernel == "rglru_scan"
                 else (ssm_mod, "ssd_chunk_scan"))
    wrapper, captured = getattr(mod, attr), {}
    names = (("a", "bx", "h0") if kernel == "rglru_scan"
             else ("xbar", "a_log", "Bm", "Cm"))

    def keep(*args, **kw):
        if not captured:
            captured.update({k: (a.clone() if isinstance(a, torch.Tensor)
                                 else a) for k, a in zip(names, args)})
            if kernel == "ssd_scan":
                captured["chunk"] = kw["chunk"]
            else:
                captured.setdefault("h0", None)
        return wrapper(*args, **kw)

    eng = ServingEngine(model, ServeConfig(batch=4, max_len=4096))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    setattr(mod, attr, keep)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        setattr(mod, attr, wrapper)
    assert all(r.done and len(r.out_tokens) == 16 for r in reqs), [
        (r.rid, r.done, len(r.out_tokens)) for r in reqs]
    assert bool(torch.stack(finite).all()), "a logit is not finite"
    assert stats["prefill_launches"] == [per_prefill] * len(reqs), stats[
        "prefill_launches"]
    assert launches[kernel] == per_prefill * len(reqs), launches
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.out_tokens) for r in reqs)
    decode_tokens = tokens - len(reqs)
    emit(f"lm_serve_{arch.split('-')[0]}", arch=arch,
         layers=cfg.num_layers, layer_kinds={
             k: cfg.layer_kinds().count(k) for k in set(cfg.layer_kinds())},
         d_model=cfg.d_model, parameters=n_params,
         config_param_count=cfg.param_count(), param_bytes=param_bytes,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         init_seconds=init_s, slots=4, max_len=4096, requests=len(reqs),
         prompt_lens=[len(p) for p in prompts], new_tokens=16,
         ticks=eng.ticks, engine_wall_seconds=wall,
         tokens_per_sec=tokens / wall,
         decode_tokens_per_sec=decode_tokens / (sum(stats["decode_ms"])
                                                / 1e3),
         prefill_ms=stats["prefill_ms"],
         prefill_tokens_per_sec=sum(len(p) for p in prompts)
         / (sum(stats["prefill_ms"]) / 1e3),
         decode_ms_per_tick=statistics.median(stats["decode_ms"]),
         decode_ms_per_tick_mean=statistics.fmean(stats["decode_ms"]),
         peak_memory_bytes=peak, launches=launches,
         launches_per_prefill=stats["prefill_launches"],
         first_tokens=[r.out_tokens[:4] for r in reqs[:2]])
    attn = None
    if capture_attention:
        attn = _capture_attention(torch, np, model, layers_mod)
    del model, eng, reqs, orig_prefill, orig_decode
    gc.collect()
    torch.cuda.empty_cache()
    return launches, captured, attn


def _capture_attention(torch, np, model, layers_mod):
    """q, k, v (after RoPE) and the output of the first attention layer of
    a 2,048-token prefill, in the kernel's (B, heads, S, D) layout.  At S
    <= window the layer's local attention is causal attention."""
    orig, store = layers_mod._sdpa_blockwise, {}

    def keep(q, k, v, mask_kind, window, compute_dtype, *rest):
        out = orig(q, k, v, mask_kind, window, compute_dtype, *rest)
        if not store:
            assert mask_kind == "local" and q.shape[1] <= window
            store.update(q=q.transpose(1, 2).contiguous(),
                         k=k.transpose(1, 2).contiguous(),
                         v=v.transpose(1, 2).contiguous(),
                         layer_out=out.transpose(1, 2).contiguous())
        return out
    tokens = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (1, 2048))
    layers_mod._sdpa_blockwise = keep
    try:
        model.prefill(torch.from_numpy(tokens).to(model.device))
    finally:
        layers_mod._sdpa_blockwise = orig
    store["causal"] = True
    return store


def lm_kernels_phase(torch, np, captured):
    """Phase 13b: each LM kernel on the inputs the serving phases gave
    it, held, timed and bounded: rglru_scan from the recurrentgemma-9b
    prefill, ssd_scan from the mamba2-2.7b prefill, flash_attention on
    q/k/v of a recurrentgemma-9b attention layer (also held against the
    layer's own attention output) and at a yi-6b train_4k-like shape."""
    rg = captured["rglru_scan"]
    entries = [_lm_entry(torch, np, "rglru_scan", rg)]
    emit("kernel", **entries[-1])
    entries.append(_lm_entry(torch, np, "ssd_scan", captured["ssd_scan"]))
    # the main path's shape runs the tensor-core body
    assert entries[-1]["body"] == "mma", entries[-1]["body"]
    emit("kernel", **entries[-1])
    attn = captured["attention"]
    layer_out = attn.pop("layer_out")
    entry = _lm_entry(torch, np, "flash_attention", attn,
                      note="q/k/v of recurrentgemma-9b's first attention "
                           "layer at a 2,048-token prefill")
    from repro_torch.kernels.flash_attention.ops import flash_attention
    err, ok = _lm_close(torch, flash_attention(attn["q"], attn["k"],
                                               attn["v"], True),
                        layer_out, LM_TOL["bfloat16"])
    if not ok:
        raise AssertionError(f"flash_attention differs from the layer's "
                             f"attention output: max |err| {err}")
    entry["layer_attention_max_abs_err"] = err
    rng = np.random.default_rng(20271)
    yi = _lm_random(torch, np, rng, "flash_attention", attn["q"].device,
                    "bfloat16", causal=True, **FLASH_TRAIN_SHAPE)
    entry["train_4k_shape"] = _lm_entry(
        torch, np, "flash_attention", yi,
        note="yi-6b train_4k-like shape, random bf16 inputs")
    emit("kernel", **entry)
    entries.append(entry)
    return entries


def lm_parity_phase(torch, np):
    """Phase 16: each family's smoke() config in float32 through
    ServingEngine on the card and on the CPU, same weights (6 prompts of
    3-11 tokens, 3 slots, 8 new tokens): identical tokens, prefill and
    decode logits within 2e-4; then ``python -m repro_torch.launch.serve
    --arch recurrentgemma-9b`` once on the card."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    for arch in LM_FAMILIES:
        t0 = time.perf_counter()
        cfg = replace(get_arch(arch).smoke(), compute_dtype="float32",
                      param_dtype="float32")
        cpu = Model(cfg, device="cpu", seed=0)
        models = {"cpu": cpu, CARD: copy.deepcopy(cpu).to(CARD)}
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 9, 7, 3, 11, 6)]
        tokens, logits = {}, {}
        for dev, model in models.items():
            logits[dev] = []
            for entry in ("prefill", "decode_step"):
                orig = getattr(model, entry)

                def rec(*args, _orig=orig, _seen=logits[dev], **kw):
                    out = _orig(*args, **kw)
                    _seen.append(out[0].cpu())
                    return out
                setattr(model, entry, rec)
            eng = ServingEngine(model, ServeConfig(batch=3, max_len=64))
            reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            assert all(r.done for r in reqs)
            tokens[dev] = [r.out_tokens for r in reqs]
        assert models[CARD].device.type == CARD
        assert tokens["cpu"] == tokens[CARD], arch
        assert len(logits["cpu"]) == len(logits[CARD])
        err = max(float((a - b).abs().max())
                  for a, b in zip(logits["cpu"], logits[CARD]))
        for a, b in zip(logits["cpu"], logits[CARD]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=arch)
        emit("lm_parity", arch=arch, requests=len(prompts),
             calls_compared=len(logits["cpu"]), tokens_identical=True,
             max_abs_logit_diff=err, tolerance=2e-4,
             seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve",
         *LM_LAUNCHER_ARGS], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and lines[-1].startswith("device " + CARD), \
        proc.stdout[-2000:] + proc.stderr[-2000:]
    emit("lm_launcher", command=" ".join(
        ["python -m repro_torch.launch.serve", *LM_LAUNCHER_ARGS]),
         summary=lines[-2], device=lines[-1],
         seconds=time.perf_counter() - t0)


def lm_phases(torch, np, dev):
    """Phases 13-16; returns the kernels-line entries of the three LM
    kernels with their launches on the two serving paths."""
    check_lm_small(torch, np, dev)
    captured = {}
    rg, captured["rglru_scan"], captured["attention"] = lm_serve_phase(
        torch, np, "recurrentgemma-9b", capture_attention=True)
    mb, captured["ssd_scan"], _ = lm_serve_phase(torch, np, "mamba2-2.7b")
    entries = lm_kernels_phase(torch, np, captured)
    captured.clear()
    torch.cuda.empty_cache()
    launches = {"rglru_scan": rg["rglru_scan"] + mb["rglru_scan"],
                "ssd_scan": rg["ssd_scan"] + mb["ssd_scan"],
                # no model calls flash attention (nor the JAX package's)
                "flash_attention": rg["flash_attention"]
                + mb["flash_attention"]}
    assert launches["flash_attention"] == 0, launches
    for e in entries:
        e["launches"] = launches[e["name"]]
    lm_parity_phase(torch, np)
    return entries



# --------------------------------------------------------------------- #
# Phases 17-18: the exact engine's cross-validation and Table 1
# --------------------------------------------------------------------- #
CROSSVAL_N = 256
CROSSVAL_DYNAMICS = ("none", "link_add", "churn", "crash")
CROSSVAL_ENGINES = ("vec", "windowed", "sharded")
# the kernels the cross-validated engines must run on the card
CROSSVAL_KERNELS = ("fused_sweep", "deliver_sweep", "frontier_sweep",
                    "retire_reduce", "latency_hist")
TABLE1_EXACT_N = (50, 100, 200)
TABLE1_VEC_N = 50_000
TABLE1_VEC_MESSAGES = 32


def crossval_spec(dynamics: str, engine: str, device=None, check=True):
    """The twin of tests/test_vecsim.py:33 through the front door:
    N=256, the dynamics family's default scenario, the vec side on
    ``engine`` (the windowed and sharded ones with the full delivered
    matrix, the sharded one on one rank; ``engine="live"`` serves
    Poisson arrivals instead), replayed on the exact engine."""
    from repro_torch.api import (DynamicsSpec, LiveSpec, MetricsSpec,
                                 RunSpec, ShardSpec, WindowSpec)
    metrics = MetricsSpec(crossval=check, oracle=check)
    if engine == "live":
        return RunSpec(mode="live", n=CROSSVAL_N, seed=7, device=device,
                       dynamics=DynamicsSpec(kind=dynamics),
                       live=LiveSpec(rate=4.0, messages=200),
                       window=WindowSpec(window=64, seg_len=8,
                                         collect="full"),
                       metrics=metrics)
    kw = {}
    if engine != "vec":
        kw["window"] = WindowSpec(collect="full")
    if engine == "sharded":
        kw["shard"] = ShardSpec(devices=1)
    return RunSpec(n=CROSSVAL_N, engine=engine, device=device,
                   dynamics=DynamicsSpec(kind=dynamics), metrics=metrics,
                   **kw)


class _ExactTimer:
    """Times the exact engine's replays inside ``run``: wraps the
    cross-validation module's ``run_exact`` while installed."""

    def __init__(self):
        from repro_torch.core.vecsim import crossval
        self.mod, self.inner, self.seconds = crossval, crossval.run_exact, []

    def __enter__(self):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.inner(*a, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)
        self.mod.run_exact = timed
        return self

    def __exit__(self, *exc):
        self.mod.run_exact = self.inner


def crossval_phase(torch, np):
    """Phase 17: ``metrics.crossval`` on the card — each dynamics family
    on the vec, windowed and sharded engines and one live run, every
    crossval_ok true and every oracle clean, each run byte-identical to
    the same spec on the CPU; returns the kernels' launches."""
    from repro_torch.api import run
    from repro_torch.core.vecsim import kernels as kx
    cases = [(d, e) for d in CROSSVAL_DYNAMICS for e in CROSSVAL_ENGINES]
    cases.append(("none", "live"))
    total = {}
    for dynamics, engine in cases:
        torch.cuda.synchronize()
        kx.reset_launches()
        with _ExactTimer() as timer:
            t0 = time.perf_counter()
            rep = run(crossval_spec(dynamics, engine))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in kx.LAUNCHES.items() if v}
        name = f"{dynamics}/{engine}"
        assert rep.device.startswith(CARD), (name, rep.device)
        assert rep.crossval_ok is True, name
        assert rep.oracle.ok, (name, rep.oracle.summary())
        assert len(timer.seconds) == 1, (name, timer.seconds)
        assert launches, (name, "no kernel launched")
        cpu = run(crossval_spec(dynamics, engine, device="cpu",
                                check=False))
        a, b = rep.result, cpu.result
        assert vars(a.stats) == vars(b.stats), name
        np.testing.assert_array_equal(a.delivered, b.delivered, name)
        np.testing.assert_array_equal(a.series, b.series, name)
        for key in a.state:
            np.testing.assert_array_equal(a.state[key], b.state[key],
                                          f"{name}/{key}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit("crossval", dynamics=dynamics, engine=rep.engine,
             mode=rep.spec.mode, n=rep.n, messages=rep.m_app,
             rounds=rep.rounds, window=rep.window,
             delivered_frac=rep.delivered_frac, crossval_ok=rep.crossval_ok,
             oracle=rep.oracle.summary(), card_equals_cpu=True,
             vec_wall_seconds=rep.wall_seconds,
             exact_wall_seconds=timer.seconds[0], run_wall_seconds=wall,
             launches=launches)
    missing = [k for k in CROSSVAL_KERNELS if not total.get(k)]
    assert not missing, ("crossval launched none of", missing, total)
    emit("crossval_launches", runs=len(cases), launches=total)
    return total


def table1_spec(protocol: str, engine: str, n: int, m_app: int, k: int,
                device=None, oracle: bool = False):
    """One cell of benchmarks/bench_table1.py (``_spec``): a ring
    overlay of out-degree ``k``, ``m_app`` uniform broadcasts, seed n."""
    from repro_torch.api import (MetricsSpec, RunSpec, TopologySpec,
                                 TrafficSpec)
    return RunSpec(protocol=protocol, engine=engine, device=device, n=n,
                   seed=n, topology=TopologySpec(kind="ring", k=k),
                   traffic=TrafficSpec(kind="uniform", messages=m_app),
                   metrics=MetricsSpec(oracle=oracle))


_VC_FIELDS = ("delivered", "rcv", "vc", "origins", "stamp", "series")


def _vc_equal(np, a, b, what):
    for key in _VC_FIELDS:
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype, (what, key)
        np.testing.assert_array_equal(x, y, f"{what}/{key}")
    for key in b.state:
        np.testing.assert_array_equal(a.state[key], b.state[key],
                                      f"{what}/state/{key}")
    assert vars(a.stats) == vars(b.stats), what
    assert (a.comparisons, a.max_pending) == (b.comparisons,
                                              b.max_pending), what


def table1_phase(torch, np):
    """Phase 18: Table 1 through the front door — bench_table1's exact
    arm (N = 50, 100, 200; pc and vc, oracle on) and its vec arm at the
    largest size (N=50,000, ring K=6, 32 broadcasts; pc on the vec
    engine, vc on the vector-clock engine, both on the card), the vc
    card run byte-equal to the CPU run, and a vc cross-validation at
    N=256 on the card; returns the kernels' launches."""
    from repro_torch.api import build_scenario, run
    from repro_torch.core.vecsim import (churn_scenario, cross_validate,
                                         kernels as kx, run_vec_vc)
    for n in TABLE1_EXACT_N:
        m_app, k = n // 2, max(3, n // 32)
        for protocol in ("pc", "vc"):
            rep = run(table1_spec(protocol, "exact", n, m_app, k,
                                  oracle=True))
            assert rep.engine == "exact" and rep.device == "object"
            assert rep.oracle.ok, (n, protocol, rep.oracle.summary())
            assert rep.delivered_frac == 1.0, (n, protocol)
            procs = rep.result.procs.values()
            emit("table1", arm="exact", protocol=protocol, n=n,
                 messages=m_app, k=k,
                 overhead_bytes_per_msg=rep.extras["overhead_bytes_per_msg"],
                 comparisons_per_delivery=rep.extras.get(
                     "comparisons_per_delivery"),
                 space_entries=(rep.extras["space_entries_max"]
                                if protocol == "vc" else
                                max(len(p.received) for p in procs)),
                 deliveries=rep.stats.deliveries,
                 host_wall_seconds=rep.wall_seconds,
                 oracle=rep.oracle.summary())

    n, m_app, k = TABLE1_VEC_N, TABLE1_VEC_MESSAGES, 6
    launches = {}
    for protocol in ("pc", "vc"):
        spec = table1_spec(protocol, "vec", n, m_app, k)
        torch.cuda.synchronize()
        kx.reset_launches()
        rep = run(spec)
        torch.cuda.synchronize()
        for key, v in kx.LAUNCHES.items():
            if v:
                launches[key] = launches.get(key, 0) + v
        assert rep.engine == "vec" and rep.device.startswith(CARD)
        assert rep.delivered_frac == 1.0, (protocol, rep.delivered_frac)
        scn = build_scenario(spec)
        t0 = time.perf_counter()
        if protocol == "pc":
            assert kx.LAUNCHES["fused_sweep"] == rep.rounds, kx.LAUNCHES
            cpu = run(table1_spec(protocol, "vec", n, m_app, k,
                                  device="cpu"))
            cpu_wall = cpu.wall_seconds
            a, b = rep.result, cpu.result
            assert vars(a.stats) == vars(b.stats)
            np.testing.assert_array_equal(a.delivered, b.delivered)
            np.testing.assert_array_equal(a.series, b.series)
            drain = {}
            space = m_app      # every process ends up knowing every id
        else:
            assert not any(kx.LAUNCHES.values()), kx.LAUNCHES
            cpu = run_vec_vc(scn, device="cpu", time_drain=True)
            cpu_wall = time.perf_counter() - t0
            _vc_equal(np, rep.result, cpu, "table1/vc")
            t0 = time.perf_counter()
            timed = run_vec_vc(scn, time_drain=True)
            timed_wall = time.perf_counter() - t0
            _vc_equal(np, timed, cpu, "table1/vc/timed")
            iters = timed.drain_iters
            drain = dict(drain_rounds=int((iters > 0).sum()),
                         drain_iterations=int(iters.sum()),
                         drain_iterations_max=int(iters.max()),
                         drain_card_ms=timed.drain_ms,
                         drain_timed_run_wall_seconds=timed_wall,
                         drain_cpu_ms=cpu.drain_ms)
            space = rep.extras["space_entries_max"]
        emit("table1", arm="vec", protocol=protocol, n=n, messages=m_app,
             k=k, rounds=rep.rounds,
             overhead_bytes_per_msg=rep.extras["overhead_bytes_per_msg"],
             comparisons_per_delivery=rep.extras.get(
                 "comparisons_per_delivery"),
             max_pending=rep.extras.get("max_pending"),
             space_entries=space, sends=rep.stats.sent_messages,
             deliveries=rep.stats.deliveries,
             card_wall_seconds=rep.wall_seconds,
             cpu_wall_seconds=cpu_wall, card_equals_cpu=True, **drain)

    scn = churn_scenario(seed=CROSSVAL_N + 17, n=CROSSVAL_N)
    t0 = time.perf_counter()
    out = cross_validate(scn, protocol="vc")
    assert out["vec"].device.startswith(CARD)
    assert out["vec_multiset"] == out["exact_multiset"]
    assert out["vec_clocks"] == out["exact_clocks"]
    assert out["vec_report"].ok and out["exact_report"].ok
    emit("table1_vc_crossval", n=scn.n, messages=scn.m_app,
         adds=scn.n_adds, deliveries=len(out["vec_multiset"]),
         clocks_equal=True, multisets_equal=True,
         seconds=time.perf_counter() - t0)
    return launches


if __name__ == "__main__":
    sys.exit(main())
