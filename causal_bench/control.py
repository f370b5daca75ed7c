"""The control of a cell's ``correct``: the cell at its own size with the
control path its configuration names (``"control"``) switched on, which
breaks one guarantee the configuration states, judged by the same
reference as the benchmark's runs.  It has to come out not correct.

    python3 causal_bench/control.py --workload <cell> --seeds 1,2,3

One repetition a seed, each printed as a JSON line with the compared
numbers.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from causal_bench.harness.spec import load_cell, load_driver
    from causal_bench.run import _environment
    _environment()
    spec = load_cell(args.workload)
    driver = load_driver(spec)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = driver.Cell(spec, seed, "cuda")
        cell.warm()
        verdict = cell.judge([cell.rep(control=True)], "cuda")
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=verdict.correct,
            failed=verdict.failed,
            checks={k: v[0] for k, v in verdict.checks.items()})),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
