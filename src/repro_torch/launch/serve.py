"""Serving launcher: batched generation with continuous batching, on the
arch's ``smoke()`` reduction in float32 with random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --requests 8

The port of the JAX package's ``launch/serve.py``: the same flags and
printout, plus ``--device`` (the card by default, ``cpu`` on request).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = replace(get_arch(args.arch).smoke(), compute_dtype="float32",
                  param_dtype="float32")
    model = build_model(cfg, device=args.device, seed=args.seed)
    eng = ServingEngine(model, ServeConfig(batch=args.slots,
                                           max_len=args.max_len,
                                           seed=args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        r = Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=plen).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
        reqs.append(r)
        eng.submit(r)
    t0 = time.time()
    eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    for r in reqs:
        print(f"req {r.rid:2d} prompt[{len(r.prompt):2d}] -> "
              f"{r.out_tokens}")
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s, {eng.ticks} engine ticks, "
          f"batch-efficiency {total_tokens/max(eng.ticks,1):.2f} tok/tick)")
    print(f"device {model.device}")
    return reqs, eng


if __name__ == "__main__":
    main()
