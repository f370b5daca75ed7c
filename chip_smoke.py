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
     float64 evaluation; ssd_scan_bwd (the SSD backward kernel) against
     its plain version ``ssd_chunk_scan_bwd_ref`` on every ssd_scan small
     case in both types, each gradient within the tolerance of its type
     of its largest entry, on the body the forward's rule names (the
     tensor cores for bf16 with chunk and N at most 128, else FMA);
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
     cross-validation at N=256 on the card with equal clocks;
 19. train_parity — the yi-6b, recurrentgemma-9b and mamba2-2.7b smoke
     configs at float32, 3 train steps on the card and on the CPU, each
     step from one state: loss within 2e-5 and every gradient leaf
     within 1e-4 of its largest entry, 4 rglru_scan launches forward and
     4 backward a hybrid step, 4 ssd_scan and 4 ssd_scan_bwd launches a
     Mamba-2 step;
 19b. train_mamba2 — mamba2-2.7b at its published width, depth cut to
     16 of 64 layers, 4 AdamW steps on 1 x 2,048 tokens: step ms,
     tokens/s, peak memory, 16 ssd_scan and 16 ssd_scan_bwd launches a
     step, no call of the plain version; then, on the run's first scan
     inputs, the wrapper against its plain version (bf16 2e-2) and
     timed (the kernels line's ssd_scan entry, ``training_shape``), and
     the backward kernel (its tensor-core body) against the plain
     backward and float64 autograd (no further than 1.5 times the plain
     backward's distance), timed as the bare launch, each of its
     launches, the wrapper, the plain backward and the recompute it
     replaced (autograd through the plain forward), with its bound and
     peak memory (the kernels line's ssd_scan_bwd entry);
 20. rglru_backward — rglru_scan's backward (a second, reversed launch of
     the scan kernel) on phase 21's inputs at B=1, S=2,048, W=4,096,
     against autograd through the plain version, timed and bounded; it
     goes on the rglru_scan entry of the kernels line;
 21. train_recurrentgemma — recurrentgemma-9b at its published width,
     depth cut to 9 layers (three superblocks of rec, rec, attn), 4
     AdamW steps on 1 x 2,048 tokens: loss, grad_norm, step ms,
     tokens/s and peak memory a step, every value finite, 6 rglru_scan
     and 6 rglru_scan_bwd launches a step;
 22. gossip — causal-gossip training on the card: 4 pods of the tiny
     yi-6b config for 10 rounds with a join at round 3 and a crash at
     round 6, and 3 pods of the recurrentgemma-9b smoke config (vocab
     64) for 6 rounds: a clean
     causal report, apply logs equal to the CPU run's, a falling mean
     loss;
 23. families_parity — the smoke() configs of qwen3-moe-235b-a22b,
     grok-1-314b, whisper-small and qwen2-vl-72b at float32 on the card
     and on the CPU: forward logits (within 1e-4 of their largest),
     prefill + decode (2e-4) and 3 train steps from one state (as phase
     19); the MoE at its default capacity factors (1.25 training, with
     drops; 2.0 serving) with every call's routing — top-k experts, sort
     order, ranks, kept set — equal card against CPU; qwen2-vl on an
     image block's distinct (t, h, w) positions, whisper with
     enc_embeds;
 24. lm_serve_qwen3_moe — qwen3-moe-235b-a22b at its published width
     (128 experts top-8), depth cut to 4 of 94 layers (44.8 GB of f32
     weights), through ServingEngine: 8 greedy requests of 16 tokens on
     256-512-token prompts; tokens/s, prefill and decode ms, peak
     memory, the share of assignments dropped in the prefills;
 25. lm_serve_qwen2_vl — qwen2-vl-72b at its published width, depth cut
     to 8 of 80 layers (38 GB): one prefill of 256 patch embeddings on a
     (1, 16, 16) grid then 64 text tokens, with 3-D positions, and 16
     decode steps; then ServingEngine on 4 token prompts;
 26. whisper — whisper-small at full size (12 + 12 layers, 1,500 frames
     of enc_embeds): a prefill of 4 requests and 16 decode steps, then 4
     AdamW steps at batch 8 x 448 tokens; phases 23-26 check that no LM
     kernel ran (none sits on these families' paths);
 27. engine — the tensorized round engine (``core/engine``) at
     benchmarks/bench_engine.py's largest instance (N=10,000, K=8, 64
     broadcasts, 24 link additions and removals, 64 rounds): the card,
     the CPU and the sharded runner with one rank byte-equal, a clean
     ``analyze``; then its schedule at N=2^20 on the card: wall,
     cell-rounds/s, peak memory, no violation, nothing missing;
 28. dist — on a one-card (1, 1) ``DeviceMesh`` over NCCL:
     recurrentgemma-9b's smoke config at float32 through
     ``launch.dryrun.build_cell`` (DTensor parameters, ZeRO-1 moments)
     against the plain step on the CPU (loss 2e-5, gradients 1e-4 of
     each leaf's largest), 4 + 4 rglru_scan launches; recurrentgemma-9b
     at its published width with one superblock (3 layers), two DTensor
     train steps on 1 x 2,048 tokens built on the model's own tensors,
     the first's loss against the plain step's, step ms and peak
     memory; the GPipe pipeline with one stage;
 29. dryrun — ``python -m repro_torch.launch.dryrun`` of qwen3-8b x
     train_4k on the (16, 16) production mesh (a fake group of 256
     ranks, meta tensors), started after the build in a process of its
     own beside the card phases, its record printed.

Then the kernels line (all eleven kernels and ssd_scan_bwd, the SSD
scan's backward; launches summed over every main-path phase, 17 to 22
and 28 included), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Needs
one CUDA card; exits non-zero without one.

    python3 chip_smoke.py --ranks 4

runs only the multi-card check instead: phases 8, 9 and 10's
configurations at one rank in this process and then over 2 and over the
given number of ranks, which ``repro_torch.api.run`` starts itself
(NCCL, one card a rank), each byte-identical to the one-rank run; then
phase 30: the round engine's sharded runner over 2 and N ranks
byte-equal to one rank, and over N ranks the recurrentgemma-9b smoke
cell on a (2, N / 2) mesh against the one-card plain step and the
pipeline with N stages against the sequential stack.  It needs that
many cards.

    python3 chip_smoke.py --ab DIR

compares engine walls with another checkout on the same card (DIR, a
directory inside this checkout, e.g. the parent commit unpacked by
``git archive`` into build/parent): phase 10's run four times (the first
warms up), phase 4's four times, phase 15 twice, phase 14 twice and phase 19b
twice, with deliver_sweep timed on phase 10's round-40 inputs,
frontier_sweep on phase 4's rounds 58, 30 and 63, rglru_scan on phase
14's first prefill and ssd_scan_bwd on phase 19b's first scan inputs,
in a process of each checkout in turn, DIR, this, this, DIR.
"""

from __future__ import annotations

import json
import os
import shutil
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
        dist_ranks_phase(torch, np, int(argv[1]))
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
    # -- 29, started: the dry-run traces on the host beside the rest ---- #
    import tempfile
    dry_dir = tempfile.mkdtemp()
    dry_started = time.perf_counter()
    dry = start_dryrun(dry_dir)
    try:
        return _card_phases(torch, np, dev, dry, dry_dir, dry_started)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
        shutil.rmtree(dry_dir, ignore_errors=True)


def _card_phases(torch, np, dev, dry, dry_dir, dry_started) -> int:
    """Phases 2-28 and 29's record, then the kernels line."""

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
    # -- 19-22. training and causal-gossip training -------------------- #
    extra, fields = train_phases(torch, np)
    for e in entries:
        e["launches"] += extra.get(e["name"], 0)
        e.update(fields.get(e["name"], {}))
    # ssd_scan_bwd launches on the training paths alone
    entries.append(fields["ssd_scan_bwd"])
    # -- 23-26. the MoE, encoder-decoder and M-RoPE families ----------- #
    # (no LM kernel on their paths; each phase checks that none ran)
    family_phases(torch, np)
    # -- 27-29. the round engine, the DTensor cell and the dry-run ----- #
    engine_phase(torch, np)
    extra = dist_phase(torch, np)
    for e in entries:
        e["launches"] += extra.get(e["name"], 0)
        if e["name"] == "rglru_scan":
            e["backward"]["launches"] += extra.get("rglru_scan_bwd", 0)
    dryrun_phase(dry, dry_dir, dry_started)

    # not measured here: the card ms of the earlier designs of six
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
         ssd_scan_bwd={"train_mamba2_fma_body": 1.9344159960746765},
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
# each), and phase 19b twice (its step and the backward kernel at the
# training shape); the call numbers are filled in by ab_phase
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
for _ in range(2):
    cs.train_mamba2_phase(torch, np)
"""


def ab_phase(other: str) -> None:
    """--ab: the walls of scale_scan_off, gated, lm_serve_mamba2 and
    lm_serve_recurrentgemma and train_mamba2's step, and the card ms of
    deliver_sweep, frontier_sweep (at its three rounds), rglru_scan and
    ssd_scan_bwd on their main-path inputs (ssd_scan_bwd's launches
    each), in another checkout and in this one, alternating
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
                    "ms", "bound_ms", "max_abs_err", "round",
                    "median_step_ms_after_first", "peak_memory_bytes",
                    "per_launch_ms", "wrapper_ms", "body",
                    "peak_above_before_bytes")
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
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:30",
    # the backward of that TPU kernel, which has none: JAX differentiates
    # ssd_chunk_scan_ref (src/repro/models/ssm.py:68)
    "ssd_scan_bwd": "src/repro/kernels/ssd_scan/kernel.py:26"}
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
                 dict(b=1, s=300, h=2, p=32, n=64, chunk=256),
                 # 11 chunks of 10 heads: the backward's chunk walks in
                 # batches of 8, its head groups of 8
                 dict(b=2, s=170, h=10, p=8, n=16, chunk=16)],
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


def _ssd_bwd_inputs(torch, np, rng, inp):
    """Output gradients for the ssd_scan inputs ``inp``: dy (as xbar) and
    dh (B, H, N, P) f32, made with numpy from ``rng``."""
    x = inp["xbar"]
    b, s, h, p = x.shape
    n = inp["Bm"].shape[-1]
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32)).to(x.device, x.dtype)
    dh = torch.from_numpy(rng.standard_normal((b, h, n, p)).astype(
        np.float32)).to(x.device)
    return dy, dh


def _ssd_bwd_args(inp):
    return tuple(inp[k] for k in ("xbar", "a_log", "Bm", "Cm"))


def _leaf_close(torch, got, want, tol):
    """:func:`_grad_close` on tuples of gradients, with the largest
    |difference|: (its worst fraction, that difference, ok).  The
    gradients of a scan sum many terms of both signs (da_log is a
    reverse cumsum of them), so each is held to its own scale, as the
    CPU tests hold the plain backward to JAX's."""
    assert [g.shape for g in got] == [w.shape for w in want]
    frac, ok = _grad_close(torch, dict(enumerate(got)),
                           {i: w.float().cpu() for i, w in enumerate(want)},
                           tol)
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    return frac, err, ok


def check_ssd_bwd_small(torch, np, dev):
    """Phase 13a, the backward: ssd_scan_bwd (through the wrapper's
    ``_scan_bwd``, one count a call) against its plain version
    ``ssd_chunk_scan_bwd_ref`` on the card, on every ssd_scan small case
    in float32 and bfloat16, each gradient within the tolerance of its
    type of its largest entry; each case's body (``ssd_scan_bwd_body``)
    must be the tensor cores' for bf16 with chunk and N at most 128 and
    FMA otherwise, so that both bodies are held in both types."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd_scan.ops import _scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_scan_bwd_ref
    rng = np.random.default_rng(20272)
    worst, cases, bodies = {}, 0, {}
    for shape in LM_SMALL["ssd_scan"]:
        for dtype in ("float32", "bfloat16"):
            inp = _lm_random(torch, np, rng, "ssd_scan", dev, dtype, **shape)
            body = _ssd_bwd_body(inp)
            q = _ssd_chunk(inp)
            want_body = ("mma" if dtype == "bfloat16" and q <= 128
                         and shape["n"] <= 128 else "fma")
            assert body == want_body, (shape, dtype, body)
            key = f"{body} {dtype}"
            bodies[key] = bodies.get(key, 0) + 1
            dy, dh = _ssd_bwd_inputs(torch, np, rng, inp)
            before = LAUNCHES["ssd_scan_bwd"]
            got = _scan_bwd(*_ssd_bwd_args(inp), dy, dh, inp["chunk"])
            assert LAUNCHES["ssd_scan_bwd"] == before + 1
            want = ssd_chunk_scan_bwd_ref(*_ssd_bwd_args(inp), dy, dh,
                                          chunk=inp["chunk"])
            frac, err, ok = _leaf_close(torch, got, want, LM_TOL[dtype])
            if not ok:
                raise AssertionError(
                    f"ssd_scan_bwd ({body}) differs from its plain version "
                    f"on {shape} {dtype}: {frac} of a gradient's largest")
            worst[key] = max(worst.get(key, 0.0), frac)
            cases += 1
    torch.cuda.synchronize()
    assert set(bodies) == {"mma bfloat16", "fma bfloat16", "fma float32"}, \
        bodies
    emit("ssd_scan_bwd_small", cases=cases, worst_frac_of_leaf_max=worst,
         tolerance=LM_TOL, ssd_scan_bwd_bodies=bodies)


def _ssd_chunk(inp) -> int:
    """The chunk ssd_scan uses on these inputs."""
    from repro_torch.kernels.ssd_scan.ref import chunk_len
    return chunk_len(inp["xbar"].shape[1], inp["chunk"])


def _ssd_body(inp) -> str:
    """The body ssd_scan runs on these inputs: "mma" or "fma"."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_body
    return ssd_scan_body(_ssd_chunk(inp), inp["Bm"].shape[-1],
                         inp["xbar"].dtype)


def _ssd_bwd_body(inp) -> str:
    """The body ssd_scan_bwd runs on these inputs: "mma" or "fma"."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd_body
    return ssd_scan_bwd_body(_ssd_chunk(inp), inp["Bm"].shape[-1],
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


def _timed_serve(torch, model, prompts, max_len, slots=4, new=16):
    """``prompts`` through ``ServingEngine`` (``slots`` slots, caches of
    ``max_len``, ``new`` greedy tokens each), every prefill and decode
    step timed on the host clock between syncs.  Gates: every request
    done with ``new`` tokens, every logit finite.  Returns (requests,
    engine, {"prefill_ms", "prefill_launches" (the LM kernels' launches
    in each prefill), "decode_ms"}, the run's wall, its launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    stats = dict(prefill_ms=[], prefill_launches=[], decode_ms=[])
    finite = []
    orig_prefill, orig_decode = model.prefill, model.decode_step

    def prefill(tokens, pad_to=None):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t = time.perf_counter()
        last, caches = orig_prefill(tokens, pad_to=pad_to)
        torch.cuda.synchronize()
        stats["prefill_ms"].append((time.perf_counter() - t) * 1e3)
        stats["prefill_launches"].append(
            {k: v - before[k] for k, v in LAUNCHES.items()})
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

    eng = ServingEngine(model, ServeConfig(batch=slots, max_len=max_len))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    model.prefill, model.decode_step = prefill, decode_step
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        del model.prefill, model.decode_step
    assert all(r.done and len(r.out_tokens) == new for r in reqs), [
        (r.rid, r.done, len(r.out_tokens)) for r in reqs]
    assert bool(torch.stack(finite).all()), "a logit is not finite"
    return reqs, eng, stats, wall, launches


def _serve_fields(torch, prompts, reqs, eng, stats, wall):
    """The serving metrics of a :func:`_timed_serve` run, for its line."""
    tokens = sum(len(r.out_tokens) for r in reqs)
    return dict(
        requests=len(reqs), prompt_lens=[len(p) for p in prompts],
        new_tokens=len(reqs[0].out_tokens), ticks=eng.ticks,
        engine_wall_seconds=wall, tokens_per_sec=tokens / wall,
        decode_tokens_per_sec=(tokens - len(reqs))
        / (sum(stats["decode_ms"]) / 1e3),
        prefill_ms=stats["prefill_ms"],
        prefill_tokens_per_sec=sum(len(p) for p in prompts)
        / (sum(stats["prefill_ms"]) / 1e3),
        decode_ms_per_tick=statistics.median(stats["decode_ms"]),
        decode_ms_per_tick_mean=statistics.fmean(stats["decode_ms"]),
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        first_tokens=[r.out_tokens[:4] for r in reqs[:2]])


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
    from repro_torch.models import Model

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

    setattr(mod, attr, keep)
    try:
        reqs, eng, stats, wall, launches = _timed_serve(torch, model,
                                                        prompts, 4096)
    finally:
        setattr(mod, attr, wrapper)
    per = [c[kernel] for c in stats["prefill_launches"]]
    assert per == [per_prefill] * len(reqs), per
    assert launches[kernel] == per_prefill * len(reqs), launches
    stats["prefill_launches"] = per
    emit(f"lm_serve_{arch.split('-')[0]}", arch=arch,
         layers=cfg.num_layers, layer_kinds={
             k: cfg.layer_kinds().count(k) for k in set(cfg.layer_kinds())},
         d_model=cfg.d_model, parameters=n_params,
         config_param_count=cfg.param_count(), param_bytes=param_bytes,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         init_seconds=init_s, slots=4, max_len=4096,
         **_serve_fields(torch, prompts, reqs, eng, stats, wall),
         launches=launches, launches_per_prefill=stats["prefill_launches"])
    attn = None
    if capture_attention:
        attn = _capture_attention(torch, np, model, layers_mod)
    del model, eng, reqs
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
    check_ssd_bwd_small(torch, np, dev)
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


# --------------------------------------------------------------------- #
# Phases 19-22: training and causal-gossip training
# --------------------------------------------------------------------- #
TRAIN_PARITY_ARCHS = ("yi-6b", "recurrentgemma-9b", "mamba2-2.7b")
TRAIN_PARITY_STEPS = 3
# card against CPU at f32 (full-precision matmuls): the loss relative,
# each gradient leaf within this fraction of its largest entry (sums in
# other orders, the scan's look-back reassociating the recurrence)
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_TOL = 1e-4
# the full-width run: recurrentgemma-9b at its published width, its depth
# cut to three superblocks of (rec, rec, attn)
TRAIN_LAYERS = 9
TRAIN_SEQ = 2048
TRAIN_BATCH = 1
TRAIN_STEPS = 4
# the full-width Mamba-2 run: mamba2-2.7b's depth cut to 16 of 64 layers
TRAIN_SSM_LAYERS = 16
GOSSIP_TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2,
                   num_kv_heads=2, head_dim=16, vocab_size=64,
                   compute_dtype="float32", param_dtype="float32")
GOSSIP_ROUNDS = 10
GOSSIP_JOIN, GOSSIP_CRASH = 3, 6
GOSSIP_RG_PODS, GOSSIP_RG_ROUNDS = 3, 6


def _grad_close(torch, got, want, tol):
    """Largest |difference| of each gradient leaf over its largest entry;
    (worst fraction, every leaf within ``tol`` and finite)."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].float().cpu()
        scale = float(w.abs().max())
        frac = float((g - w).abs().max()) / max(scale, 1e-30)
        if not bool(torch.isfinite(g).all()) or frac > tol:
            return frac, False
        worst = max(worst, frac)
    return worst, True


def _lm_launches(cfg):
    """The LM kernels' launches of one forward (or one backward) of
    ``cfg``: a scan a recurrent layer, a scan a Mamba-2 layer."""
    kinds = cfg.layer_kinds()
    return {"rglru_scan": kinds.count("rec"), "ssd_scan": kinds.count("ssm"),
            "flash_attention": 0}


def _train_parity(torch, np, cfg, extra=None, routing=None):
    """``cfg`` (a smoke config at f32) on the card and on the CPU from
    the same weights, TRAIN_PARITY_STEPS train steps of SyntheticLM
    batches (4 x 64, plus the arrays of ``extra``, e.g. positions or
    enc_embeds); before each step the card takes the CPU's parameters
    and optimizer state, so every step starts from one state.  Loss and
    every gradient leaf held card against CPU, then the steps' loss,
    grad_norm and clip_scale; each gradient evaluation and each step
    launches the LM kernels :func:`_lm_launches` times forward and the
    RG-LRU scan's reversed launch as often backward.  ``routing``, if
    given, is called around each gradient evaluation (a context
    manager).  The SSD scan's backward kernel launches as often as its
    forward.  Returns (per-step rows, the card's launches)."""
    import contextlib
    import copy

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.step import make_grad_fn, make_train_step

    models = {"cpu": Model(cfg, device="cpu", seed=0)}
    models[CARD] = copy.deepcopy(models["cpu"]).to(CARD)
    params = {d: dict(m.named_parameters()) for d, m in models.items()}
    opt = {d: init_opt_state(params[d]) for d in models}
    steps = {d: make_train_step(m, AdamWConfig(lr=1e-3))
             for d, m in models.items()}
    grads = {d: make_grad_fn(m) for d, m in models.items()}
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=1))
    want = dict(_lm_launches(cfg))
    want["rglru_scan_bwd"] = want["rglru_scan"]
    want["ssd_scan_bwd"] = want["ssd_scan"]
    rows, total = [], {}
    for step in range(TRAIN_PARITY_STEPS):
        batch = dict(data.batch(step), **(extra or {}))
        with torch.no_grad():
            for k, p in params[CARD].items():
                p.copy_(params["cpu"][k])
        opt[CARD] = type(opt["cpu"])(*(
            None if x is None else
            {k: v.to(CARD) for k, v in x.items()} if isinstance(x, dict)
            else x.to(CARD) for x in opt["cpu"]))
        out = {}
        torch.cuda.synchronize()
        reset_launches()
        for d in models:
            with (routing(d) if routing else contextlib.nullcontext()):
                (loss, _), g = grads[d](params[d], batch)
            out[d] = (float(loss), {k: v.detach().float().cpu()
                                    for k, v in g.items()})
        torch.cuda.synchronize()
        grad_launches = dict(LAUNCHES)
        assert grad_launches == want, (grad_launches, want)
        loss_err = abs(out[CARD][0] - out["cpu"][0]) / abs(out["cpu"][0])
        frac, ok = _grad_close(torch, out[CARD][1], out["cpu"][1],
                               TRAIN_GRAD_TOL)
        if loss_err > TRAIN_LOSS_RTOL or not ok:
            raise AssertionError(
                f"train_parity {cfg.name} step {step}: loss {out[CARD][0]} "
                f"card vs {out['cpu'][0]} cpu, worst gradient leaf "
                f"{frac} of its largest")
        reset_launches()
        metrics = {}
        for d in models:
            params[d], opt[d], m = steps[d](params[d], opt[d], batch)
            metrics[d] = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == want, (dict(LAUNCHES), want)
        for k, v in LAUNCHES.items():
            total[k] = total.get(k, 0) + v + grad_launches[k]
        for key in ("loss", "grad_norm", "clip_scale"):
            a, b = metrics[CARD][key], metrics["cpu"][key]
            assert abs(a - b) <= 1e-4 * abs(b), (cfg.name, step, key, a, b)
        rows.append(dict(step=step, loss_card=out[CARD][0],
                         loss_cpu=out["cpu"][0], loss_rel_err=loss_err,
                         grad_worst_leaf_frac=frac,
                         aux_card=metrics[CARD]["aux"],
                         aux_cpu=metrics["cpu"]["aux"],
                         grad_norm_card=metrics[CARD]["grad_norm"],
                         grad_norm_cpu=metrics["cpu"]["grad_norm"],
                         launches=grad_launches))
    return rows, total


def train_parity_phase(torch, np):
    """Phase 19: the yi-6b, recurrentgemma-9b and mamba2-2.7b smoke
    configs at f32, 3 train steps card against CPU from one state
    (:func:`_train_parity`): 4 rglru_scan launches forward and 4
    backward a hybrid step, 4 ssd_scan and 4 ssd_scan_bwd launches a
    Mamba-2 step."""
    from dataclasses import replace

    from repro_torch.configs import get_arch

    total = {}
    for arch in TRAIN_PARITY_ARCHS:
        t0 = time.perf_counter()
        cfg = replace(get_arch(arch).smoke(), compute_dtype="float32",
                      param_dtype="float32")
        rows, launches = _train_parity(torch, np, cfg)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit("train_parity", arch=arch, steps=rows,
             launches_per_forward=_lm_launches(cfg),
             loss_rtol=TRAIN_LOSS_RTOL, grad_tol_of_leaf_max=TRAIN_GRAD_TOL,
             seconds=time.perf_counter() - t0)
    return total


def _timed_train(torch, np, step_fn, params, opt, batches, tokens):
    """``step_fn`` over ``batches``, each step timed on the host clock
    between syncs, with the allocator's peak and the launch counts reset
    before it.  Gates: loss and grad_norm finite.  Returns (a row a step
    — loss, grad_norm, clip_scale, step_ms, tokens/s of ``tokens`` a
    step, peak memory, its launches —, params, opt, the run's launches
    summed)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    rows, launches = [], {}
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        per = {k: v for k, v in LAUNCHES.items() if v}
        for k, v in per.items():
            launches[k] = launches.get(k, 0) + v
        assert np.isfinite([loss, gnorm]).all(), (i, loss, gnorm)
        rows.append(dict(step=i, loss=loss, grad_norm=gnorm,
                         clip_scale=float(m["clip_scale"]), step_ms=ms,
                         tokens_per_sec=tokens / (ms / 1e3),
                         peak_memory_bytes=torch.cuda.max_memory_allocated(),
                         launches=per))
    return rows, params, opt, launches


def _ssd_bwd_bound(inp):
    """(bound_ms, bound_by, flops, bytes) of the SSD backward on the
    forward's inputs ``inp``: the inputs, dy and dh read once and the four
    gradients written once, over 3.35 TB/s, against the products it
    needs — dY X^T and M^T dY on each head's lower triangle; B dH, dY
    H_prev^T and X dH^T a head; the two state walks' B^T diag(w) X and
    C^T diag(e^l) dY a head; C B^T, S B and S^T C once a chunk (S the
    heads' dCB summed) — over 989 TFLOP/s."""
    from repro_torch.kernels.ssd_scan.ref import chunk_len
    x = inp["xbar"]
    b, s, h, p = x.shape
    n = inp["Bm"].shape[-1]
    q = chunk_len(s, inp["chunk"])
    nc = -(-s // q)
    tri = q * (q + 1) // 2
    flops = 2 * b * nc * (h * (2 * tri * p + 5 * q * n * p) + 3 * tri * n)
    nbytes = 2 * sum(inp[k].numel() * inp[k].element_size()
                     for k in ("xbar", "a_log", "Bm", "Cm")) \
        + x.numel() * x.element_size() + 4 * b * h * n * p
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes)


def _peak_above(torch, fn):
    """(the allocator's peak during one ``fn()``, that peak less what was
    allocated before it), in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - base


def _per_launch_ms(torch, fn, reps=5):
    """Device ms of one launch of each kernel ``fn()`` launches, by kernel
    name, from ``torch.profiler`` (CUPTI) over ``reps`` calls, or None
    where it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t and "kernel" in e.key:
            out[e.key.split("(")[0].split("::")[-1].split("<")[0]] = \
                t / e.count / 1e3
    return out or None


def ssd_bwd_entry(torch, np, inp):
    """The kernels-line entry of ssd_scan_bwd on the forward inputs
    ``inp`` (the training shape): output gradients drawn from a seeded
    generator; the kernel through ``_SSDScan`` (``autograd.grad`` of
    ``ssd_chunk_scan``) held against the plain backward
    ``ssd_chunk_scan_bwd_ref`` (each gradient within the tolerance of its
    type of its largest entry) and against autograd through the plain
    forward in float64; timed as the bare launch (outputs allocated
    before), the wrapper's forward and backward less its
    forward, the plain backward, and the design it replaced — autograd
    through ``ssd_chunk_scan_ref`` recomputed on the card; bounded by
    :func:`_ssd_bwd_bound`; the device ms of each of its launches; the
    allocator's peak of the wrapper's backward and of the recompute.  On
    bf16 inputs the kernel must run its tensor-core body and stay within
    1.5 times the plain backward's distance from float64."""
    from repro_torch.kernels.ssd_scan.ops import (_scan_bwd,
                                                  launch_ssd_scan_bwd,
                                                  ssd_chunk_scan)
    from repro_torch.kernels.ssd_scan.ref import (chunk_len,
                                                  ssd_chunk_scan_bwd_ref,
                                                  ssd_chunk_scan_ref)

    x, al, bm, cm = _ssd_bwd_args(inp)
    chunk = inp["chunk"]
    dtype = _lm_dtype("ssd_scan", inp)
    tol = LM_TOL[dtype]
    s, n = x.shape[1], bm.shape[-1]
    q = chunk_len(s, chunk)
    assert s % q == 0, (s, q)
    dy, dh = _ssd_bwd_inputs(torch, np, np.random.default_rng(4), inp)
    args = [t.detach().requires_grad_() for t in (x, al, bm, cm)]

    def forward():
        return ssd_chunk_scan(*args, chunk=chunk)

    def forward_backward():
        return torch.autograd.grad(forward(), args, (dy, dh))

    y, _ = forward()
    assert type(y.grad_fn).__name__ == "_SSDScanBackward", y.grad_fn
    del y
    got = forward_backward()
    want = ssd_chunk_scan_bwd_ref(x, al, bm, cm, dy, dh, chunk=chunk)
    frac, err, ok = _leaf_close(torch, got, want, tol)
    if not ok:
        raise AssertionError(f"ssd_scan_bwd differs from its plain version "
                             f"at the training shape: {frac} of a "
                             f"gradient's largest entry")
    wide = [t.detach().double().requires_grad_() for t in (x, al, bm, cm)]
    truth = torch.autograd.grad(ssd_chunk_scan_ref(*wide, chunk=chunk),
                                wide, (dy.double(), dh.double()))
    del wide
    f64_frac, f64_err, _ = _leaf_close(
        torch, tuple(g.double() for g in got), truth, tol)
    plain_frac, plain_err, _ = _leaf_close(
        torch, tuple(g.double() for g in want), truth, tol)
    del got, want, truth
    body = _ssd_bwd_body(inp)
    if dtype == "bfloat16":
        assert body == "mma", body
        assert f64_frac <= 1.5 * plain_frac, (f64_frac, plain_frac)

    outs = [torch.empty_like(t) for t in (x, al, bm, cm)]
    launch = lambda: launch_ssd_scan_bwd(x, al, bm, cm, dy, dh, *outs, q)
    ms = _time_fn(torch, launch, 20)
    both_ms = _time_fn(torch, forward_backward, 10, queued=False)
    fwd_ms = _time_fn(torch, forward, 10, queued=False)
    plain_ms = _time_fn(torch, lambda: ssd_chunk_scan_bwd_ref(
        x, al, bm, cm, dy, dh, chunk=chunk), 5, queued=False)

    def recompute():
        ref_args = [t.detach().requires_grad_() for t in (x, al, bm, cm)]
        return torch.autograd.grad(ssd_chunk_scan_ref(*ref_args, chunk=chunk),
                                   ref_args, (dy, dh))
    recompute_ms = _time_fn(torch, recompute, 5, queued=False)
    ms2 = _time_fn(torch, launch, 20)
    per_launch = _per_launch_ms(torch, launch)
    del outs
    bwd_peak, bwd_extra = _peak_above(
        torch, lambda: _scan_bwd(x, al, bm, cm, dy, dh, chunk))
    rec_peak, rec_extra = _peak_above(torch, recompute)
    bound_ms, bound_by, flops, nbytes = _ssd_bwd_bound(inp)
    return dict(
        name="ssd_scan_bwd", route="cuda",
        source=f"{LM_KSRC}/ssd_scan_bwd.cu",
        replaces=LM_REPLACES["ssd_scan_bwd"], launches=None,
        max_abs_err=err, ms=min(ms, ms2), plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=list(x.shape), n=n, chunk=chunk, dtype=dtype, body=body,
        tolerance=tol, tolerance_of="each gradient's largest entry",
        max_frac_of_leaf_max=frac, flops=flops, bytes=nbytes,
        ms_repeats=[ms, ms2],
        wrapper_ms=both_ms - fwd_ms, forward_and_backward_ms=both_ms,
        forward_ms=fwd_ms, recompute_ms=recompute_ms,
        f64_max_abs_err=f64_err, f64_frac_of_leaf_max=f64_frac,
        plain_f64_max_abs_err=plain_err, plain_f64_frac_of_leaf_max=plain_frac,
        per_launch_ms=per_launch,
        peak_memory_bytes=bwd_peak, peak_above_before_bytes=bwd_extra,
        recompute_peak_memory_bytes=rec_peak,
        recompute_peak_above_before_bytes=rec_extra,
        note="the SSD backward kernel, on the inputs of the mamba2 training "
             "run's first ssd_chunk_scan call, random dy and dh; wrapper_ms "
             "= the wrapper's forward and backward less its forward; "
             "recompute_ms = the design it replaced, autograd through "
             "ssd_chunk_scan_ref on the card")


def train_mamba2_phase(torch, np):
    """Phase 19b: mamba2-2.7b at its published width (d_model 2,560, 80
    SSD heads x 64, N 128, chunks of 128, vocab 50,280 tied; f32
    parameters, bf16 compute), its depth cut to 16 of 64 layers, 4 AdamW
    steps on 1 x 2,048 tokens of SyntheticLM: loss, step ms, tokens/s,
    peak memory, 16 ssd_scan and 16 ssd_scan_bwd launches a step, no
    call of the plain version (a counter round ``ops.ssd_chunk_scan_ref``
    reads 0), and both kernels' tensor-core bodies at the run's shape.
    Then, on the inputs of the run's first ssd_scan call (B=1,
    S=2,048, H=80, P=64, N=128, bf16, the tensor-core body): the wrapper
    held against its plain version (bf16 2e-2) and against float64,
    timed; and the backward kernel's entry (:func:`ssd_bwd_entry`).
    Returns (the run's launches, the training shape's ssd_scan entry,
    ssd_scan_bwd's entry)."""
    import gc
    from dataclasses import replace

    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.step import make_train_step

    cfg = replace(get_arch("mamba2-2.7b"), num_layers=TRAIN_SSM_LAYERS)
    model, init_s = _fresh_model(torch, cfg)
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    step_fn = make_train_step(model, AdamWConfig())
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=0))
    wrapper, captured = ssm_mod.ssd_chunk_scan, {}
    plain, plain_calls = ssd_ops.ssd_chunk_scan_ref, []

    def keep(xbar, a_log, Bm, Cm, chunk):
        if not captured:
            captured.update(xbar=xbar.detach().clone(),
                            a_log=a_log.detach().clone(),
                            Bm=Bm.detach().clone(), Cm=Cm.detach().clone(),
                            chunk=chunk)
        return wrapper(xbar, a_log, Bm, Cm, chunk=chunk)

    def counted_plain(*args, **kw):
        plain_calls.append(1)
        return plain(*args, **kw)

    ssm_mod.ssd_chunk_scan = keep
    ssd_ops.ssd_chunk_scan_ref = counted_plain
    try:
        rows, params, opt, launches = _timed_train(
            torch, np, step_fn, params, opt,
            (data.batch(i) for i in range(TRAIN_STEPS)),
            TRAIN_SEQ * TRAIN_BATCH)
    finally:
        ssm_mod.ssd_chunk_scan = wrapper
        ssd_ops.ssd_chunk_scan_ref = plain
    for r in rows:
        assert r["launches"] == {"ssd_scan": cfg.num_layers,
                                 "ssd_scan_bwd": cfg.num_layers}, \
            r["launches"]
    assert not plain_calls, len(plain_calls)
    assert all(bool(torch.isfinite(p).all()) for p in params.values())
    # the training shape runs both kernels' tensor-core bodies
    bodies = {"ssd_scan": _ssd_body(captured),
              "ssd_scan_bwd": _ssd_bwd_body(captured)}
    assert bodies == {"ssd_scan": "mma", "ssd_scan_bwd": "mma"}, bodies
    emit("train_mamba2", arch=cfg.name, published_layers=get_arch(
        cfg.name).num_layers, **_sizes(cfg, model), ssm_heads=cfg.ssm_heads,
         ssm_state=cfg.ssm_state, init_seconds=init_s, batch=TRAIN_BATCH,
         seq_len=TRAIN_SEQ, lr=AdamWConfig().lr, remat="none",
         steps=rows, median_step_ms_after_first=statistics.median(
             r["step_ms"] for r in rows[1:]),
         peak_memory_bytes=max(r["peak_memory_bytes"] for r in rows),
         launches=launches, plain_version_calls=len(plain_calls),
         bodies=bodies)
    del model, params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # the forward at the training shape, against its plain version
    inp = captured
    entry = _lm_entry(torch, np, "ssd_scan", inp,
                      note="the mamba2 training path's first call")
    emit("ssd_train_shape", **entry)
    bwd = ssd_bwd_entry(torch, np, inp)
    emit("ssd_train_shape_backward", **bwd)
    inp.clear()
    return launches, entry, bwd


def train_recurrentgemma_phase(torch, np, captured):
    """Phase 21: recurrentgemma-9b at its published width (d_model 4,096,
    lru_width 4,096, 16 heads x 256 with 1 KV head, d_ff 12,288, vocab
    256,000 tied, window 2,048, f32 parameters, bf16 compute), 9 layers
    (three superblocks of rec, rec, attn), trained 4 steps on batch 1 x
    2,048 tokens of SyntheticLM with AdamW at lr 3e-4, remat none,
    through ``make_train_step``.  Per step: loss, grad_norm, step ms
    (host clock, synchronized), the optimizer's share, tokens/s, peak
    memory.  Gates: every value finite, 6 rglru_scan launches and 6
    rglru_scan_bwd launches a step.  Keeps the inputs of the first
    backward call (a, h, dh of the last recurrent layer) for phase 20.
    Returns the run's launches."""
    import gc
    import itertools
    from dataclasses import replace

    import repro_torch.kernels.rglru_scan.ops as rglru_ops
    import repro_torch.training.step as step_mod
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, prefetch
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.step import make_train_step

    cfg = replace(get_arch("recurrentgemma-9b"), num_layers=TRAIN_LAYERS)
    rec = cfg.layer_kinds().count("rec")
    assert rec == 6 and cfg.layer_kinds().count("attn") == 3
    model, init_s = _fresh_model(torch, cfg)
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    n_params = sum(p.numel() for p in params.values())
    step_fn = make_train_step(model, AdamWConfig())
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=0))

    inner_update = step_mod.adamw_update
    inner_bwd = rglru_ops.rglru_scan_backward
    opt_ms = []

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_update(*a, **kw)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def keep_bwd(a, h, h0, dh):
        if not captured:
            captured.update(a=a.detach().clone(), h=h.detach().clone(),
                            h0=None if h0 is None else h0.clone(),
                            dh=dh.detach().clone())
        return inner_bwd(a, h, h0, dh)

    step_mod.adamw_update = timed_update
    rglru_ops.rglru_scan_backward = keep_bwd
    try:
        rows, params, opt, launches = _timed_train(
            torch, np, step_fn, params, opt,
            itertools.islice(prefetch(data.iterate(0)), TRAIN_STEPS),
            TRAIN_SEQ * TRAIN_BATCH)
    finally:
        step_mod.adamw_update, rglru_ops.rglru_scan_backward = (
            inner_update, inner_bwd)
    assert len(rows) == TRAIN_STEPS
    for r, o in zip(rows, opt_ms):
        r.update(optimizer_ms=o, forward_backward_ms=r["step_ms"] - o)
        emit("train_recurrentgemma_step", **r)
        assert r["launches"].get("rglru_scan") == rec, r["launches"]
        assert r["launches"].get("rglru_scan_bwd") == rec, r["launches"]
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    assert finite, "a parameter is not finite after training"
    emit("train_recurrentgemma", arch=cfg.name, layers=cfg.num_layers,
         layer_kinds={k: cfg.layer_kinds().count(k)
                      for k in set(cfg.layer_kinds())},
         d_model=cfg.d_model, lru_width=cfg.lru_width, d_ff=cfg.d_ff,
         vocab_size=cfg.vocab_size, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
         window=cfg.window, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, parameters=n_params,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
         lr=AdamWConfig().lr, remat="none", init_seconds=init_s,
         step_ms=[r["step_ms"] for r in rows],
         median_step_ms=statistics.median(r["step_ms"] for r in rows[1:]),
         tokens_per_sec_after_first=TRAIN_SEQ * TRAIN_BATCH * (
             TRAIN_STEPS - 1) / (sum(r["step_ms"] for r in rows[1:]) / 1e3),
         losses=[r["loss"] for r in rows],
         peak_memory_bytes=max(r["peak_memory_bytes"] for r in rows),
         launches=launches, launches_per_step={"rglru_scan": rec,
                                               "rglru_scan_bwd": rec})
    del model, params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def rglru_backward_phase(torch, np, inp):
    """Phase 20: the backward launch at the full-width shape, on the
    inputs phase 21's first backward call gave it (a, h, dh of B=1,
    S=2,048, W=4,096): (da, dbx) held against autograd through the plain
    version (f32 2e-5); the bare reversed launch (c, e -> r, f32) timed
    and bounded (3 x 32 MiB over 3.35 TB/s), beside the whole backward
    (flips and the da product included) and the plain scan of the same
    (c, e)."""
    from repro_torch.kernels.rglru_scan.ops import (launch_rglru_scan,
                                                    rglru_scan_backward)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    a, h, h0, dh = inp["a"], inp["h"], inp["h0"], inp["dh"]
    assert h0 is None
    b, s, w = a.shape
    assert (b, s) == (TRAIN_BATCH, TRAIN_SEQ), a.shape
    da, dbx, _ = rglru_scan_backward(a, h, h0, dh)
    # the plain reference: autograd through the step-by-step recurrence,
    # on the forward's own inputs (bx recovered from h)
    bx = (h - a.float() * torch.cat([torch.zeros_like(h[:, :1]),
                                     h[:, :-1]], 1)).to(a.dtype)
    ar = a.detach().clone().requires_grad_()
    bxr = bx.detach().clone().requires_grad_()
    href, _ = rglru_scan_ref(ar, bxr)
    want = torch.autograd.grad(href, [ar, bxr], dh)
    err, ok = _lm_close(torch, (da.to(a.dtype), dbx.to(a.dtype)),
                        tuple(want), LM_TOL[str(a.dtype).split(".")[1]])
    if not ok:
        raise AssertionError(f"rglru_scan's backward differs from autograd "
                             f"through the plain version: {err}")
    c = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    c[:, 0] = 0.0
    c[:, 1:] = a[:, 1:].flip(1)
    e = dh.flip(1).float().contiguous()
    r = torch.empty_like(e)
    launch = lambda: launch_rglru_scan(c, e, None, r)
    ms = _time_fn(torch, launch, 20)
    wrapper_ms = _time_fn(torch, lambda: rglru_scan_backward(a, h, h0, dh),
                          20, queued=False)
    plain_ms = _time_fn(torch, lambda: rglru_scan_ref(c, e), 5, queued=False)
    ms2 = _time_fn(torch, launch, 20)
    nbytes = 3 * 4 * b * s * w
    flops = 2 * b * s * w
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    entry = dict(shape=[b, s, w], dtype="float32", max_abs_err=err,
                 tolerance=LM_TOL[str(a.dtype).split(".")[1]],
                 ms=min(ms, ms2), ms_repeats=[ms, ms2],
                 wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, flops=flops, library_ms=None,
                 launches_per_step=6,
                 note="the reversed scan: c = (0, a[S-1..1]), e = flip(dh) "
                      "-> r, f32, one launch of rglru_scan.cu")
    emit("rglru_backward", **entry)
    return entry


def _gossip_run(torch, arch_cfg, device, n_pods, rounds, churn, weights):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.gossip import CausalGossipTrainer, GossipConfig

    tr = CausalGossipTrainer(
        lambda: build_model(arch_cfg, device=device, seed=0), n_pods,
        GossipConfig(local_steps=2), DataConfig(arch_cfg.vocab_size, 32, 8),
        seed=0, init_state=weights)
    losses = []
    t0 = time.perf_counter()
    for r in range(rounds):
        tr.run_rounds(1, churn=None if churn is None
                      else (lambda _, t, r=r: churn(r, t)))
        losses.append(tr.mean_loss())
    if device != "cpu":
        torch.cuda.synchronize()
    return tr, losses, time.perf_counter() - t0


def gossip_phase(torch, np):
    """Phase 22: causal-gossip training on the card — 4 pods of
    tests/test_gossip.py's tiny yi-6b config for 10 rounds, a pod joining
    at round 3 and one crashing silently at round 6, and 3 pods of the
    recurrentgemma-9b smoke config (with the tiny config's vocabulary of
    64, which the pods learn within a few rounds) for 6 rounds; each also
    on the CPU
    with the same seed, the pods of both starting from one set of
    weights.  Gates: a clean causal report, every pod's apply
    log equal to the CPU run's, the mean loss falling (last round below
    the first).  Returns the LM kernels' launches."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model

    def churn(r, t):
        if r == GOSSIP_JOIN:
            t.join()
        if r == GOSSIP_CRASH:
            t.leave(next(p.pid for p in t.pods.values() if p.alive),
                    graceful=False)

    cases = [("yi-6b-tiny", replace(get_arch("yi-6b").smoke(),
                                    **GOSSIP_TINY), 4, GOSSIP_ROUNDS, churn),
             ("recurrentgemma-9b-smoke", replace(
                 get_arch("recurrentgemma-9b").smoke(), vocab_size=64,
                 compute_dtype="float32", param_dtype="float32"),
              GOSSIP_RG_PODS, GOSSIP_RG_ROUNDS, None)]
    total = {}
    for name, cfg, n_pods, rounds, ch in cases:
        weights = {k: v.detach() for k, v in Model(
            cfg, device="cpu", seed=0).named_parameters()}
        torch.cuda.synchronize()
        reset_launches()
        card, card_losses, card_s = _gossip_run(torch, cfg, CARD, n_pods,
                                                rounds, ch, weights)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        cpu, cpu_losses, cpu_s = _gossip_run(torch, cfg, "cpu", n_pods,
                                             rounds, ch, weights)
        rep = card.causal_report()
        assert card.device.type == CARD
        assert rep.causal_ok and not rep.double_deliveries, rep.summary()
        assert rep.summary() == cpu.causal_report().summary(), name
        assert sorted(card.pods) == sorted(cpu.pods), name
        for pid, pod in card.pods.items():
            assert pod.applied == cpu.pods[pid].applied, (name, pid)
        assert card.store.bytes_stored == cpu.store.bytes_stored, name
        assert card_losses[-1] < card_losses[0], (name, card_losses)
        assert np.isfinite(card_losses).all(), card_losses
        if cfg.layer_kinds().count("rec"):
            assert launches.get("rglru_scan") and launches.get(
                "rglru_scan_bwd"), launches
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit("gossip", config=name, pods=n_pods, rounds=rounds,
             churn=None if ch is None else {"join_round": GOSSIP_JOIN,
                                            "crash_round": GOSSIP_CRASH},
             alive=sorted(p.pid for p in card.pods.values() if p.alive),
             causal=rep.summary(), apply_logs_equal_cpu=True,
             applied=sum(len(p.applied) for p in card.pods.values()),
             bytes_stored=card.store.bytes_stored,
             mean_loss_card=card_losses, mean_loss_cpu=cpu_losses,
             replica_drift=card.replica_drift(), card_seconds=card_s,
             cpu_seconds=cpu_s, launches=launches)
    return total


def train_phases(torch, np):
    """Phases 19-22; returns (the LM kernels' launches on the training
    paths, by kernel the fields they add to its kernels-line entry:
    rglru_scan's backward (its reversed launch), ssd_scan at the training
    shape, and ssd_scan_bwd's whole entry)."""
    launches = train_parity_phase(torch, np)
    mamba, ssd_train, ssd_bwd = train_mamba2_phase(torch, np)
    for k in ("ssd_scan", "ssd_scan_bwd"):
        launches[k] += mamba[k]
    captured = {}
    for k, v in train_recurrentgemma_phase(torch, np, captured).items():
        launches[k] = launches.get(k, 0) + v
    backward = rglru_backward_phase(torch, np, captured)
    captured.clear()
    torch.cuda.empty_cache()
    for k, v in gossip_phase(torch, np).items():
        launches[k] = launches.get(k, 0) + v
    backward["launches"] = launches.get("rglru_scan_bwd", 0)
    ssd_bwd["launches"] = launches["ssd_scan_bwd"]
    return launches, {"rglru_scan": dict(backward=backward),
                      "ssd_scan": dict(training_shape=ssd_train),
                      "ssd_scan_bwd": ssd_bwd}


# --------------------------------------------------------------------- #
# Phases 23-26: the MoE, encoder-decoder and M-RoPE families
# --------------------------------------------------------------------- #
FAMILY_ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b", "whisper-small",
                "qwen2-vl-72b")
# qwen2-vl's image blocks, (t, h, w): the parity phase's and the serving
# phase's (a 448 x 448 image: 32 x 32 patches of 14, merged 2 x 2)
VL_PARITY_GRID, VL_SERVE_GRID = (2, 2, 3), (1, 16, 16)
VL_SERVE_TEXT = 64
# the full-width runs' depth cuts (the models' own: 94 and 80 layers)
MOE_SERVE_LAYERS, VL_SERVE_LAYERS = 4, 8
MOE_PROMPTS = (256, 512)
WHISPER_REQUESTS, WHISPER_PROMPT = 4, 32
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 8, 448, 4
NEW_TOKENS = 16


def _vl_positions(np, b, grid, text):
    """(b, 3, t h w + text) positions: an image block on a (t, h, w) grid
    (stream i its grid index i), then ``text`` tokens at one past the
    block's largest index and on, equal in all three streams."""
    t, h, w = grid
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    image = np.stack([ti.ravel(), hi.ravel(), wi.ravel()])
    start = image.max() + 1
    words = np.broadcast_to(np.arange(start, start + text), (3, text))
    pos = np.concatenate([image, words], axis=1).astype(np.int32)
    return np.broadcast_to(pos, (b,) + pos.shape).copy()


def _family_extra(np, cfg, b, s, seed):
    """The inputs beside the tokens: ``enc_embeds`` (b, S_enc, d) for the
    encoder-decoder, an image block's positions then text for M-RoPE."""
    rng = np.random.default_rng(seed)
    extra = {}
    if cfg.is_encdec:
        extra["enc_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.mrope:
        extra["positions"] = _vl_positions(
            np, b, VL_PARITY_GRID, s - int(np.prod(VL_PARITY_GRID)))
    return extra


def _no_lm_kernel(launches):
    """No TPU kernel sits on these families' paths (MoE dispatch, cross
    attention and M-RoPE are plain jnp in the JAX package too)."""
    assert not any(launches.values()), launches


def families_parity_phase(torch, np):
    """Phase 23: the smoke() configs of qwen3-moe-235b-a22b, grok-1-314b,
    whisper-small and qwen2-vl-72b at f32, on the card and on the CPU
    from the same weights: forward logits on 2 x 24 tokens (qwen2-vl on
    an image block of (2, 2, 3) then text, whisper with 24 frames of
    enc_embeds) within 1e-4 of their largest; a prefill of 16 and 8
    decode steps within 2e-4; 3 train steps from one state
    (:func:`_train_parity`).  The MoE routes at its default capacity
    factors (1.25 training, assignments dropped; 2.0 serving) and every
    call's top-k experts, sort order, ranks and kept set are equal card
    against CPU."""
    import contextlib
    import copy
    from dataclasses import replace

    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import Model

    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg = replace(get_arch(arch).smoke(), compute_dtype="float32",
                      param_dtype="float32")
        b, s, s0 = 2, 24, 16
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32)
        extra = {k: torch.from_numpy(v)
                 for k, v in _family_extra(np, cfg, b, s, 1).items()}
        cpu = Model(cfg, device="cpu", seed=0)
        models = {"cpu": cpu, CARD: copy.deepcopy(cpu).to(CARD)}
        routes = {d: [] for d in models}
        route = moe_mod.route

        @contextlib.contextmanager
        def routing(dev):
            def keep(p, c, x, train):
                r = route(p, c, x, train)
                routes[dev].append((train, r.cap) + tuple(
                    t.cpu() for t in (r.idx, r.order, r.rank, r.keep)))
                return r
            moe_mod.route = keep
            try:
                yield
            finally:
                moe_mod.route = route

        torch.cuda.synchronize()
        reset_launches()
        logits, served = {}, {}
        for dev, model in models.items():
            with routing(dev), torch.no_grad():
                logits[dev] = model(torch.from_numpy(tokens),
                                    **extra).cpu()
            pre = dict(extra)
            if "positions" in pre:
                pre["positions"] = pre["positions"][..., :s0]
            with routing(dev):
                last, caches = model.prefill(torch.from_numpy(
                    tokens[:, :s0]), pad_to=s, **pre)
                served[dev] = [last.cpu()]
                for t in range(s0, s):
                    out, caches = model.decode_step(
                        torch.from_numpy(tokens[:, t]), caches, t)
                    served[dev].append(out.cpu())
        torch.cuda.synchronize()
        _no_lm_kernel(LAUNCHES)
        frac, ok = _grad_close(torch, {"logits": logits[CARD]},
                               {"logits": logits["cpu"]}, TRAIN_GRAD_TOL)
        assert ok, (arch, "forward logits", frac)
        serve_err = max(float((a - c).abs().max())
                        for a, c in zip(served[CARD], served["cpu"]))
        for a, c in zip(served[CARD], served["cpu"]):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=arch)
        train_extra = _family_extra(np, cfg, 4, 64, 2)
        rows, launches = _train_parity(torch, np, cfg, train_extra,
                                       routing if cfg.is_moe else None)
        _no_lm_kernel(launches)
        record = {}
        if cfg.is_moe:
            assert len(routes["cpu"]) == len(routes[CARD]) > 0
            for a, c in zip(routes[CARD], routes["cpu"]):
                assert a[:2] == c[:2] and all(
                    torch.equal(x, y) for x, y in zip(a[2:], c[2:])), arch
            kept = [r[-1] for r in routes["cpu"] if r[0]]
            record = dict(
                routing_calls_compared=len(routes["cpu"]),
                routing_equal=True, capacity_factor=cfg.capacity_factor,
                capacity_factor_eval=cfg.capacity_factor_eval,
                dropped_share_training=1.0 - float(
                    sum(int(k.sum()) for k in kept))
                / sum(k.numel() for k in kept))
            assert record["dropped_share_training"] > 0, record
        emit("families_parity", arch=arch, forward_worst_frac_of_max=frac,
             serve_max_abs_diff=serve_err, serve_tolerance=2e-4,
             inputs=sorted(["tokens"] + list(extra)), train_steps=rows,
             **record, seconds=time.perf_counter() - t0)
        del models, cpu
    torch.cuda.empty_cache()


def _fresh_model(torch, cfg):
    """A seeded model of ``cfg`` on the card, the allocator's peak reset;
    returns (model, init seconds)."""
    import gc

    from repro_torch.models import Model

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, seed=0)
    torch.cuda.synchronize()
    assert model.device.type == CARD
    return model, time.perf_counter() - t0


def _sizes(cfg, model):
    params = list(model.parameters())
    return dict(layers=cfg.num_layers, d_model=cfg.d_model,
                heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                vocab_size=cfg.vocab_size,
                parameters=sum(p.numel() for p in params),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in params),
                param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype)


def lm_serve_moe_phase(torch, np):
    """Phase 24: qwen3-moe-235b-a22b at its published width (d_model
    4,096, 64 x 128 heads, 4 KV heads, 128 experts top-8 of d_ff 1,536,
    vocab 151,936 untied), its depth cut to 4 of 94 layers, seeded f32
    weights, bf16 compute, through ServingEngine: 8 greedy requests of
    16 tokens on prompts of 256-512 tokens, 4 slots.  Also the share of
    assignments dropped in the prefills (capacity factor 2.0), and for
    the first prefill each layer's busiest expert's assignments over the
    mean."""
    from dataclasses import replace

    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_arch

    cfg = replace(get_arch("qwen3-moe-235b-a22b"),
                  num_layers=MOE_SERVE_LAYERS)
    model, init_s = _fresh_model(torch, cfg)
    prompts = _lm_prompts(np, cfg, *MOE_PROMPTS)
    kept, load, route = [], [], moe_mod.route

    def count(p, c, x, train):
        r = route(p, c, x, train)
        if x.shape[1] > 1:            # a prefill; a decode row is 1 token
            kept.append((r.keep.sum(), r.keep.numel()))
            load.append(torch.bincount(r.idx.flatten(),
                                       minlength=c.n_experts))
        return r
    moe_mod.route = count
    try:
        reqs, eng, stats, wall, launches = _timed_serve(
            torch, model, prompts, 1024, new=NEW_TOKENS)
    finally:
        moe_mod.route = route
    _no_lm_kernel(launches)
    assert len(kept) == cfg.num_layers * len(prompts), len(kept)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    emit("lm_serve_qwen3_moe", arch=cfg.name, published_layers=get_arch(
        cfg.name).num_layers, **_sizes(cfg, model), n_experts=e,
         top_k=cfg.top_k, capacity_factor_eval=cfg.capacity_factor_eval,
         init_seconds=init_s, slots=4, max_len=1024,
         **_serve_fields(torch, prompts, reqs, eng, stats, wall),
         dropped_share_prefill=1.0 - float(sum(int(k) for k, _ in kept))
         / sum(n for _, n in kept),
         busiest_expert_over_mean=[float(x.max() / x.float().mean())
                                   for x in load[:cfg.num_layers]],
         expert_cast_bytes_per_layer=3 * e * d * f * (4 + 2),
         launches=launches)
    del model, eng, reqs


def lm_serve_vl_phase(torch, np):
    """Phase 25: qwen2-vl-72b at its published width (d_model 8,192, 64 x
    128 heads, 8 KV heads, d_ff 29,568, vocab 152,064 untied, M-RoPE
    sections (16, 24, 24)), its depth cut to 8 of 80 layers, seeded f32
    weights, bf16 compute: one request through ``Model.prefill(embeds=,
    positions=)`` — 256 patch embeddings on a (1, 16, 16) grid, then 64
    text tokens' embeddings, 3-D positions — and 16 greedy decode steps;
    its last logits differ from those of the same prompt at default
    positions.  Then ServingEngine on 4 token prompts of 64-128 tokens,
    16 greedy tokens each."""
    from dataclasses import replace

    from repro_torch.configs import get_arch

    cfg = replace(get_arch("qwen2-vl-72b"), num_layers=VL_SERVE_LAYERS)
    model, init_s = _fresh_model(torch, cfg)
    n_img = int(np.prod(VL_SERVE_GRID))
    s = n_img + VL_SERVE_TEXT
    pos = torch.from_numpy(_vl_positions(np, 1, VL_SERVE_GRID,
                                         VL_SERVE_TEXT)).to(CARD)
    gen = torch.Generator(device=CARD).manual_seed(1)
    text = torch.randint(0, cfg.vocab_size, (1, VL_SERVE_TEXT),
                         generator=gen, device=CARD)
    with torch.no_grad():
        embeds = torch.cat([torch.randn((1, n_img, cfg.d_model),
                                        generator=gen, device=CARD) * 0.02,
                            model.embed[text]], dim=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = model.prefill(embeds=embeds, positions=pos,
                                 pad_to=s + NEW_TOKENS)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    flat, _ = model.prefill(embeds=embeds)
    mrope_moved = float((flat - last).abs().max())
    assert mrope_moved > 0, "3-D positions changed nothing"
    tok, out, decode_ms, finite = last.argmax(-1), [], [], [last]
    for i in range(NEW_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(tok, caches, s + i)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(logits)
        tok = logits.argmax(-1)
        out.append(int(tok[0]))
    assert all(bool(torch.isfinite(x).all()) for x in finite)
    image_peak = torch.cuda.max_memory_allocated()
    del caches, finite
    prompts = _lm_prompts(np, cfg, 64, 128, n=4, seed=2)
    reqs, eng, stats, wall, launches = _timed_serve(
        torch, model, prompts, 256, new=NEW_TOKENS)
    _no_lm_kernel(launches)
    emit("lm_serve_qwen2_vl", arch=cfg.name, published_layers=get_arch(
        cfg.name).num_layers, **_sizes(cfg, model),
         mrope_sections=list(cfg.mrope_sections), init_seconds=init_s,
         image_grid=list(VL_SERVE_GRID), image_tokens=n_img,
         text_tokens=VL_SERVE_TEXT, image_prefill_ms=prefill_ms,
         image_prefill_tokens_per_sec=s / (prefill_ms / 1e3),
         image_decode_ms=decode_ms,
         image_decode_ms_per_tick=statistics.median(decode_ms),
         image_new_tokens=out, mrope_vs_default_max_abs_logit=mrope_moved,
         image_peak_memory_bytes=image_peak, slots=4, max_len=256,
         engine=_serve_fields(torch, prompts, reqs, eng, stats, wall),
         launches=launches)
    del model, eng, reqs


def whisper_phase(torch, np):
    """Phase 26: whisper-small at full size (12 encoder and 12 decoder
    layers, d_model 768, 12 heads, d_ff 3,072, vocab 51,865, 1,500
    frames of enc_embeds; f32 parameters, bf16 compute): a prefill of 4
    requests of 32 tokens with their enc_embeds (the encoder included)
    and 16 greedy decode steps; then 4 AdamW steps at batch 8 x 448
    tokens of SyntheticLM with enc_embeds: step ms, tokens/s (decoder
    tokens), peak memory, every value finite."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.step import make_train_step

    cfg = get_arch("whisper-small")
    model, init_s = _fresh_model(torch, cfg)
    gen = torch.Generator(device=CARD).manual_seed(3)
    b, s = WHISPER_REQUESTS, WHISPER_PROMPT
    enc = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                      device=CARD) * 0.1
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=CARD)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    last, caches = model.prefill(tokens, enc_embeds=enc,
                                 pad_to=s + NEW_TOKENS)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    assert caches[0][0]["b0_x"][0].shape == (b, cfg.encoder_seq,
                                             cfg.num_kv_heads, cfg.head_dim)
    tok, decode_ms, finite = last.argmax(-1), [], [last]
    for i in range(NEW_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(tok, caches, s + i)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(logits)
        tok = logits.argmax(-1)
    assert all(bool(torch.isfinite(x).all()) for x in finite)
    _no_lm_kernel(LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated()
    del caches, finite, enc

    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    step_fn = make_train_step(model, AdamWConfig())
    data = SyntheticLM(DataConfig(cfg.vocab_size, WHISPER_TRAIN_SEQ,
                                  WHISPER_TRAIN_BATCH, seed=0))
    enc = torch.randn((WHISPER_TRAIN_BATCH, cfg.encoder_seq, cfg.d_model),
                      generator=gen, device=CARD) * 0.1
    rows, params, opt, launches = _timed_train(
        torch, np, step_fn, params, opt,
        (dict(data.batch(i), enc_embeds=enc)
         for i in range(WHISPER_TRAIN_STEPS)),
        WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ)
    _no_lm_kernel(launches)
    assert all(bool(torch.isfinite(p).all()) for p in params.values())
    emit("whisper", arch=cfg.name, **_sizes(cfg, model),
         encoder_layers=cfg.encoder_layers, encoder_seq=cfg.encoder_seq,
         init_seconds=init_s, requests=b, prompt_len=s,
         prefill_ms=prefill_ms, decode_ms=decode_ms,
         decode_ms_per_tick=statistics.median(decode_ms),
         decode_tokens_per_sec=b / (statistics.median(decode_ms) / 1e3),
         serve_peak_memory_bytes=serve_peak, train_batch=WHISPER_TRAIN_BATCH,
         train_seq=WHISPER_TRAIN_SEQ, lr=AdamWConfig().lr, train_steps=rows,
         median_step_ms_after_first=statistics.median(
             r["step_ms"] for r in rows[1:]),
         train_peak_memory_bytes=max(r["peak_memory_bytes"] for r in rows))
    del model, params, opt, step_fn


def family_phases(torch, np):
    """Phases 23-26."""
    import gc

    families_parity_phase(torch, np)
    lm_serve_moe_phase(torch, np)
    lm_serve_vl_phase(torch, np)
    whisper_phase(torch, np)
    gc.collect()
    torch.cuda.empty_cache()



# --------------------------------------------------------------------- #
# Phases 27-30: the tensorized round engine, the DTensor train cell, the
# GPipe pipeline and the dry-run
# --------------------------------------------------------------------- #
# benchmarks/bench_engine.py's instance (random_instance seed 5, k 8, 64
# broadcasts, 24 link additions, 24 removals, 64 rounds) at its largest
# N, and its schedule at N = 2^20
ENGINE_N, ENGINE_SCALE_N, ENGINE_SEED = 10_000, 1 << 20, 5
ENGINE_SCHEDULE = dict(k=8, m_app=64, n_adds=24, n_rms=24, rounds=64,
                       mode="pc")
DIST_ARCH = "recurrentgemma-9b"
DIST_SMOKE_BATCH, DIST_SMOKE_SEQ = 4, 64
DIST_FULL_LAYERS, DIST_FULL_SEQ = 3, 2048
PIPE_M, PIPE_B, PIPE_D = 6, 8, 16
DRYRUN_CELL = ("qwen3-8b", "train_4k")
DRYRUN_TIMEOUT = 900


def _whole(t):
    """A DTensor's full value (other tensors as they are)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _engine_instance(np, seed: int, n: int):
    """``random_instance``'s structure at any N without its per-row
    Python loop: a ring in slot 0, k - 2 random targets a row (never the
    row itself; repeats allowed), the last slot free, delays 1-3, and
    its schedule (broadcasts, link additions on the free slot by
    distinct processes at distinct rounds, removals off the ring)."""
    from repro_torch.core.engine import EngineConfig, Schedule

    k, rounds, max_delay = (ENGINE_SCHEDULE["k"], ENGINE_SCHEDULE["rounds"],
                            3)
    m_app, n_adds, n_rms = (ENGINE_SCHEDULE[key] for key in
                            ("m_app", "n_adds", "n_rms"))
    rng = np.random.default_rng(seed)
    rows = np.arange(n)
    adj0 = np.full((n, k), -1, np.int64)
    adj0[:, 0] = (rows + 1) % n
    adj0[:, 1:k - 1] = (rows[:, None] + rng.integers(
        1, n, size=(n, k - 2))) % n
    delay0 = rng.integers(1, max_delay + 1, size=(n, k))
    last = max(1, rounds - 3 * max_delay - 6)
    i32 = np.int32
    sched = Schedule(
        np.sort(rng.integers(0, last, size=m_app)).astype(i32),
        rng.integers(0, n, size=m_app).astype(i32),
        np.sort(rng.choice(last, size=n_adds, replace=False)).astype(i32),
        rng.choice(n, size=n_adds, replace=False).astype(i32),
        np.full(n_adds, k - 1, i32),
        rng.integers(0, n, size=n_adds).astype(i32),
        rng.integers(1, max_delay + 1, size=n_adds).astype(i32),
        np.sort(rng.integers(0, last, size=n_rms)).astype(i32),
        rng.integers(0, n, size=n_rms).astype(i32),
        rng.integers(1, k - 1, size=n_rms).astype(i32))
    # an added link never points at its own process
    sched.add_q[:] = np.where(sched.add_q == sched.add_p,
                              (sched.add_q + 1) % n, sched.add_q)
    return EngineConfig(n=n, k=k, rounds=rounds, mode="pc"), sched, adj0, \
        delay0


def _on_card(torch, fn):
    """(fn(), seconds) between card syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def engine_phase(torch, np):
    """Phase 27: the tensorized round engine (``core/engine``, plain
    tensor operations, no kernel).  At benchmarks/bench_engine.py's
    largest instance (N = 10,000): ``run_engine`` on the card, on the
    CPU and ``run_engine_sharded`` with one rank in this process, each
    ``delivered`` byte-equal, ``analyze`` clean; at N = 2^20 with the same
    schedule: the card run's wall, cell-rounds/s (N x M x rounds a
    second, bench_engine's unit) and peak memory, ``analyze`` with no
    violation and nothing missing."""
    from repro_torch.core.engine import analyze, random_instance, run_engine
    from repro_torch.core.engine.sharded import run_engine_sharded

    inst = random_instance(ENGINE_SEED, n=ENGINE_N, **ENGINE_SCHEDULE)
    cfg, sched = inst[0], inst[1]
    card, card_s = _on_card(torch, lambda: run_engine(*inst))
    t0 = time.perf_counter()
    cpu = run_engine(*inst, device="cpu")
    cpu_s = time.perf_counter() - t0
    np.testing.assert_array_equal(card, cpu)
    one, one_s = _on_card(torch, lambda: run_engine_sharded(*inst))
    np.testing.assert_array_equal(one, cpu)
    rep = analyze(card, sched)
    assert rep["violations"] == 0 and rep["missing"] == 0, rep
    cells = cfg.n * sched.m_total * cfg.rounds
    emit("engine", n=cfg.n, k=cfg.k, m_total=sched.m_total,
         rounds=cfg.rounds, byte_equal_card_cpu=True,
         byte_equal_sharded_one_rank=True, card_seconds=card_s,
         cpu_seconds=cpu_s, sharded_one_rank_seconds=one_s,
         card_cell_rounds_per_sec=cells / card_s,
         cpu_cell_rounds_per_sec=cells / cpu_s, **rep)
    big = _engine_instance(np, ENGINE_SEED, ENGINE_SCALE_N)
    torch.cuda.reset_peak_memory_stats()
    d, wall = _on_card(torch, lambda: run_engine(*big))
    rep = analyze(d, big[1])
    assert rep["violations"] == 0 and rep["missing"] == 0, rep
    emit("engine_scale", n=big[0].n, k=big[0].k, m_total=big[1].m_total,
         rounds=big[0].rounds, card_seconds=wall,
         card_cell_rounds_per_sec=big[0].n * big[1].m_total * big[0].rounds
         / wall, peak_memory_bytes=torch.cuda.max_memory_allocated(), **rep)


def _pipeline_inputs(np, stages: int):
    rng = np.random.default_rng(0)
    d = PIPE_D
    return dict(w=(rng.standard_normal((stages, d, d)) * d ** -0.5).astype(
                    np.float32),
                b=(rng.standard_normal((stages, d)) * 0.1).astype(np.float32),
                mb=rng.standard_normal((PIPE_M, PIPE_B, d)).astype(
                    np.float32))


def _pipeline_check(torch, np, mesh, device):
    """The GPipe pipeline of tanh(x @ w + b) stages over the mesh's
    "stage" ranks against the sequential stack: outputs within rtol
    1e-5, the gradients of mean(out ** 2) (summed over the stages)
    within rtol 1e-4, as JAX's test holds its own.  Returns the errors."""
    import torch.distributed as dist

    from repro_torch.sharding.pipeline import pipeline

    inp = _pipeline_inputs(np, mesh.size())

    def params():
        return {k: torch.tensor(inp[k], device=device, requires_grad=True)
                for k in ("w", "b")}

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    mb = torch.tensor(inp["mb"], device=device)
    p = params()
    out = pipeline(stage, mesh)(p, mb)
    (out ** 2).mean().backward()
    grads = {}
    for k, v in p.items():
        g = v.grad.clone()
        dist.all_reduce(g, group=mesh.get_group("stage"))
        grads[k] = g
    q = params()
    x = mb
    for s in range(mesh.size()):
        x = stage({k: v[s] for k, v in q.items()}, x)
    (x ** 2).mean().backward()
    torch.testing.assert_close(out, x, rtol=1e-5, atol=1e-5)
    for k in grads:
        torch.testing.assert_close(grads[k], q[k].grad, rtol=1e-4, atol=1e-5)
    return dict(out=float((out - x).detach().abs().max()),
                grads=max(float((grads[k] - q[k].grad).abs().max())
                          for k in grads))


def _dist_smoke(torch, np):
    """The recurrentgemma-9b smoke config at float32 and one batch: the
    CPU model and its weights (numpy), to be loaded on the card."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model

    cfg = replace(get_arch(DIST_ARCH).smoke(), compute_dtype="float32",
                  param_dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, DIST_SMOKE_SEQ,
                                   DIST_SMOKE_BATCH, seed=5)).batch(0)
    return cfg, model, batch


def _cell_on_card(torch, np, cfg, weights, batch, mesh):
    """The smoke cell through ``build_cell`` on ``mesh`` from the CPU
    model's weights: the loss and gradients of the step's grad function
    (full values, on the CPU) and its kernel launches, then one train
    step.  Returns (loss, grads, launches of the grad function, step
    metrics)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.models import build_model
    from repro_torch.sharding.policy import use_mesh
    from repro_torch.training.step import make_grad_fn

    model = build_model(cfg, seed=0)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    tb = {k: torch.as_tensor(v, device=model.device)
          for k, v in batch.items()}
    b, s = tb["labels"].shape
    fn, args, _, _ = build_cell(cfg, ShapeSpec("dist_smoke", s, b, "train"),
                                mesh, remat="none", model=model, batch=tb)
    params, _, placed = args
    torch.cuda.synchronize()
    reset_launches()
    with use_mesh(mesh), implicit_replication():
        (loss, _), grads = make_grad_fn(model)(params, placed)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    grads = {k: _whole(g).cpu() for k, g in grads.items()}
    _, _, met = fn(*args)
    return float(_whole(loss)), grads, launches, met


def _cell_close(torch, np, loss, grads, want_loss, want):
    """Loss within 2e-5 and every gradient within 1e-4 of its leaf's
    largest (the training parity's tolerances); returns the worst
    gradient error as a share of its leaf's largest."""
    np.testing.assert_allclose(loss, want_loss, rtol=TRAIN_LOSS_RTOL)
    worst = 0.0
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((grads[k] - w).abs().max())
        assert err <= TRAIN_GRAD_TOL * scale, (k, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def dist_phase(torch, np):
    """Phase 28: the sharded LM path on one card, a (1, 1) ("data",
    "model") ``DeviceMesh`` over NCCL.  (a) The recurrentgemma-9b smoke
    config at float32 through ``launch.dryrun.build_cell`` (DTensor
    parameters, ZeRO-1 moments, the batch over "data"), from the CPU
    model's weights: the loss within 2e-5 and every gradient within 1e-4
    of its leaf's largest against the plain one-device step on the CPU,
    with rglru_scan and rglru_scan_bwd launched (the RG-LRU layers run
    the kernel on their local shards), then one train step.  (b)
    recurrentgemma-9b at its published width with one superblock (3
    layers: rec, rec, attn; f32 parameters, bf16 compute), 1 x 2,048
    tokens: two DTensor train steps, timed (the first plans DTensor's
    layouts), with their peak memory, built
    on the model's own tensors (a one-rank mesh wraps them without a
    copy), its loss against the plain step's loss on the same tensors
    (bf16 tolerance).  (c) the pipeline with one stage on the card.
    Returns the launches of (a) and (b)."""
    from dataclasses import replace

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.step import make_grad_fn, make_loss_fn

    mesh = make_local_mesh(1, 1)
    launches = {}
    try:
        cfg, cpu_model, batch = _dist_smoke(torch, np)
        (want_loss, _), want = make_grad_fn(cpu_model)(
            dict(cpu_model.named_parameters()), batch)
        weights = {k: v.detach().numpy()
                   for k, v in cpu_model.state_dict().items()}
        loss, grads, counts, met = _cell_on_card(torch, np, cfg, weights,
                                                 batch, mesh)
        worst = _cell_close(torch, np, loss, grads, float(want_loss), want)
        rec = cfg.layer_kinds().count("rec")
        assert counts.get("rglru_scan") == rec, counts
        assert counts.get("rglru_scan_bwd") == rec, counts
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        emit("dist_smoke", arch=cfg.name, mesh="1x1", batch=DIST_SMOKE_BATCH,
             seq_len=DIST_SMOKE_SEQ, loss=loss, cpu_loss=float(want_loss),
             worst_grad_error_share=worst, step_loss=float(_whole(
                 met["loss"])), launches=counts)

        cfg = replace(get_arch(DIST_ARCH), num_layers=DIST_FULL_LAYERS)
        model, init_s = _fresh_model(torch, cfg)
        batch = SyntheticLM(DataConfig(cfg.vocab_size, DIST_FULL_SEQ, 1,
                                       seed=0)).batch(0)
        own = dict(model.named_parameters())
        with torch.no_grad():
            plain = float(make_loss_fn(model)(own, batch)[0])
        tb = {k: torch.as_tensor(v, device=model.device)
              for k, v in batch.items()}
        fn, args, _, _ = build_cell(
            cfg, ShapeSpec("dist_full", DIST_FULL_SEQ, 1, "train"), mesh,
            remat="none", model=model, batch=tb)
        assert all(args[0][k].to_local().data_ptr() == p.data_ptr()
                   for k, p in own.items()), "the cell copied a parameter"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        # the first step plans DTensor's layouts, the second reuses them
        (_, _, met), ms = _on_card(torch, lambda: fn(*args))
        (_, _, met2), ms2 = _on_card(torch, lambda: fn(*args))
        counts = {k: v for k, v in LAUNCHES.items() if v}
        loss = float(_whole(met["loss"]))
        rel = abs(loss - plain) / abs(plain)
        assert rel <= LM_TOL["bfloat16"], (loss, plain)
        assert np.isfinite(float(_whole(met2["loss"])))
        rec = cfg.layer_kinds().count("rec")
        assert counts.get("rglru_scan") == 2 * rec, counts
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        emit("dist_full", arch=cfg.name, **_sizes(cfg, model), mesh="1x1",
             batch=1, seq_len=DIST_FULL_SEQ, init_seconds=init_s,
             step_ms=[ms * 1e3, ms2 * 1e3], loss=loss, plain_loss=plain,
             loss_rel_diff=rel,
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             launches=counts)
        del model, own, args, fn
        pipe = _pipeline_check(torch, np, init_device_mesh(
            CARD, (1,), mesh_dim_names=("stage",)), torch.device(CARD))
        emit("dist_pipeline", stages=1, microbatches=PIPE_M, **pipe)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return launches


def start_dryrun(out_dir: str):
    """Phase 29, started: ``python -m repro_torch.launch.dryrun`` on
    DRYRUN_CELL at the (16, 16) production mesh in a process of its own
    (its fake process group of 256 ranks must not meet this process's
    groups; the card hidden from it), writing its record to
    ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    arch, shape = DRYRUN_CELL
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", os.path.join(out_dir, "dryrun.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def dryrun_phase(proc, out_dir: str, started: float) -> None:
    """Phase 29: the dry-run's record (estimates for a production H100
    cluster, traced on meta tensors on the host; no card involved)."""
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out + err)[-3000:]
    with open(os.path.join(out_dir, "dryrun.json")) as fh:
        rec, = json.load(fh)
    emit("dryrun", wall_seconds_since_start=time.perf_counter() - started,
         **rec)


# --ranks: the engine, the cell and the pipeline over NCCL ranks
def _dist_rank(rank, world, store, args, out):
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.engine.sharded import run_engine_sharded
    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    try:
        inst, cell = args
        res = {"engine": run_engine_sharded(*inst)}
        if cell is not None:
            cfg, weights, batch = cell
            mesh = make_local_mesh(2, world // 2)
            loss, grads, counts, _ = _cell_on_card(torch, np, cfg, weights,
                                                   batch, mesh)
            res["cell"] = (loss, grads, counts)
            from torch.distributed.device_mesh import init_device_mesh
            res["pipeline"] = _pipeline_check(torch, np, init_device_mesh(
                "cuda", (world,), mesh_dim_names=("stage",)),
                torch.device("cuda", rank))
        if rank == 0:
            with open(out, "wb") as fh:
                pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


def dist_ranks_phase(torch, np, most: int) -> None:
    """Phase 30 (``--ranks N``): the sharded round engine over 2 and N
    NCCL ranks (one card a rank) byte-equal to one rank in this process;
    over N ranks also the recurrentgemma-9b smoke cell on a (2, N / 2)
    mesh against the plain one-device step on this process's card, and
    the pipeline with N stages against the sequential stack."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core.engine import random_instance
    from repro_torch.core.engine.sharded import run_engine_sharded
    from repro_torch.training.step import make_grad_fn

    inst = random_instance(ENGINE_SEED, n=ENGINE_N, **ENGINE_SCHEDULE)
    one = run_engine_sharded(*inst)
    cfg, cpu_model, batch = _dist_smoke(torch, np)
    weights = {k: v.detach().numpy()
               for k, v in cpu_model.state_dict().items()}
    card = cpu_model.to(CARD)
    (want_loss, _), want = make_grad_fn(card)(
        dict(card.named_parameters()), batch)
    want = {k: g.cpu() for k, g in want.items()}
    for world in sorted({2, most}):
        cell = (cfg, weights, batch) if world == most and most % 2 == 0 \
            else None
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out.pkl")
            t0 = time.perf_counter()
            mp.start_processes(_dist_rank, nprocs=world, join=True,
                               start_method="spawn", args=(
                                   world, os.path.join(tmp, "store"),
                                   (inst, cell), out))
            wall = time.perf_counter() - t0
            with open(out, "rb") as fh:
                res = pickle.load(fh)
        np.testing.assert_array_equal(res["engine"][:inst[0].n], one)
        emit("dist_ranks_engine", world=world, n=inst[0].n,
             byte_equal_to_one_rank=True, launch_and_run_seconds=wall)
        if cell is not None:
            loss, grads, counts = res["cell"]
            worst = _cell_close(torch, np, loss, grads, float(want_loss),
                                want)
            assert counts.get("rglru_scan"), counts
            emit("dist_ranks_cell", world=world, mesh=f"2x{world // 2}",
                 arch=cfg.name, loss=loss, one_card_loss=float(want_loss),
                 worst_grad_error_share=worst, launches_rank0=counts)
            emit("dist_ranks_pipeline", stages=world, **res["pipeline"])


if __name__ == "__main__":
    sys.exit(main())
