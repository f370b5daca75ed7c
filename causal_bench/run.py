"""The benchmark of ``repro_torch`` on the card: one run of one cell.

    python3 causal_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic
mix and metrics are found by name from ``BENCHMARK.json``; the run
prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown`` of the
device trace, and last ``checks``: each number compared with the
reference beside its limit, which also end standard error.

It exits non-zero and prints no result when the card is missing, when
a module of JAX or of the JAX package was loaded, or when set-up
fails.  The program's kernel build, and every cache a run writes, lie
in ``build/`` of the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """One host thread for the CPU side of PyTorch (the program's host
    work is one Python thread; more intra-op threads only add jitter),
    and every build and kernel cache of the program inside the
    checkout, at fixed paths, so that a checkout's second run finds
    them.  Set before PyTorch is imported."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from causal_bench.harness.main import measure
    from causal_bench.harness.spec import load_cell
    spec = load_cell(args.workload)
    import torch
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return measure(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)


if __name__ == "__main__":
    sys.exit(main())
