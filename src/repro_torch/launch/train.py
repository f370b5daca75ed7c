"""Training launcher.

The port of the JAX package's ``launch/train.py``, with its flags plus
``--device`` (the card by default, ``cpu`` on request).  Two modes:

  * ``--mode spmd``   — synchronous training on one card, as the JAX
    launcher trains on its default device (multi-card training is the
    DTensor cell of ``launch.dryrun.build_cell``, as in JAX);
  * ``--mode gossip`` — multi-pod causal-gossip training (the paper's
    protocol as the cross-pod plane), simulated in-process: N pods, local
    AdamW + PC-broadcast outer updates, optional churn and compression;
    it ends on the causal check (no violation, no double delivery).

spmd checkpoints and resumes through ``repro_torch.checkpoint`` (atomic
commit, the data resumed at the checkpoint's ``data_step``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch yi-6b --steps 50 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --mode gossip --pods 4 --rounds 10 --churn
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLM, prefetch
from repro_torch.models import build_model
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            init_opt_state)
from repro_torch.training.step import make_train_step


def _state(params, opt_state):
    return {"params": params, "opt": opt_state._asdict()}


def spmd_main(args):
    cfg = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = replace(cfg.smoke(), compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, device=args.device, seed=args.seed,
                        remat=args.remat)
    params = dict(model.named_parameters())
    step_fn = make_train_step(model, AdamWConfig(lr=args.lr),
                              microbatches=args.microbatches)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len,
                                  args.batch, seed=args.seed))
    opt_state = init_opt_state(params)
    start_step = 0
    if args.ckpt_dir and (s := ckpt.latest_step(args.ckpt_dir)) is not None:
        print(f"resuming from step {s}")
        state, meta = ckpt.restore(args.ckpt_dir, s,
                                   like=_state(params, opt_state))
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state["params"][k])
        opt_state = OptState(**state["opt"])
        start_step = meta["data_step"]

    m = None
    t0 = time.time()
    for i, batch in enumerate(prefetch(data.iterate(start_step))):
        step = start_step + i
        if step >= args.steps:
            break
        params, opt_state, m = step_fn(params, opt_state, batch)
        if step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({dt:.1f}s)",
                  flush=True)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step, _state(params, opt_state),
                      meta={"data_step": step + 1, "arch": cfg.name})
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, _state(params, opt_state),
                  meta={"data_step": args.steps, "arch": cfg.name})
    if m is None:
        print(f"done: nothing to run from step {start_step}")
        print(f"device {model.device}")
        return None
    loss = float(m["loss"])
    print(f"done: final loss {loss:.4f}")
    print(f"device {model.device}")
    return loss


def gossip_main(args):
    from repro_torch.runtime.gossip import CausalGossipTrainer, GossipConfig
    cfg = replace(get_arch(args.arch).smoke(), compute_dtype="float32",
                  param_dtype="float32")
    dc = DataConfig(cfg.vocab_size, args.seq_len, args.batch,
                    seed=args.seed)
    g = GossipConfig(local_steps=args.local_steps,
                     compress_frac=args.compress)
    tr = CausalGossipTrainer(
        lambda: build_model(cfg, device=args.device, remat="none"),
        args.pods, g, dc, seed=args.seed)

    def churn(r, t):
        if r == args.rounds // 3:
            pid = t.join()
            print(f"[round {r}] pod {pid} joined (ping-phase gated)")
        if r == 2 * args.rounds // 3:
            victim = next(p.pid for p in t.pods.values() if p.alive)
            t.leave(victim, graceful=False)
            print(f"[round {r}] pod {victim} crashed silently")

    for r in range(args.rounds):
        # run_rounds numbers its own rounds from 0; churn gets the run's
        # round (the JAX launcher passes churn itself, so its r is always
        # 0 and a run of 3 rounds or more never churns)
        tr.run_rounds(1, churn=(lambda _, t, r=r: churn(r, t))
                      if args.churn else None)
        print(f"round {r:3d} mean_loss {tr.mean_loss():.4f} "
              f"drift {tr.replica_drift():.4f}", flush=True)
    rep = tr.causal_report()
    print("causal check:", rep.summary())
    if not rep.causal_ok or rep.double_deliveries:
        raise SystemExit(f"causal check failed: {rep.summary()}")
    print(f"device {tr.device}")
    return tr.mean_loss()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["spmd", "gossip"], default="spmd")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    # gossip
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--compress", type=float, default=0.0)
    ap.add_argument("--churn", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.mode == "spmd":
        return spmd_main(args)
    return gossip_main(args)


if __name__ == "__main__":
    main()
