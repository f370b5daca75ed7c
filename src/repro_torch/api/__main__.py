"""``python -m repro_torch.api`` — run a batch RunSpec from JSON or flags.

Spec sources compose left to right: section defaults, then ``--spec``
JSON (a file path or an inline JSON object, e.g. a JAX package spec's
``to_dict()``), then individual flag overrides.  The report prints as
JSON on stdout (``--csv`` switches to ``name,us_per_call,derived``
rows).  Runs on the card unless ``--device cpu``.

    python -m repro_torch.api --protocol pc --engine vec --n 256 \\
        --dynamics churn --messages 12 --oracle
    python -m repro_torch.api --spec experiment.json
    python -m repro_torch.api --list            # registry keys
"""

from __future__ import annotations

import argparse
import json
import sys

from ..backend import DeviceUnavailableError, cuda_available
from . import (ENGINES, PROTOCOLS, SCENARIOS, TOPOLOGIES, TRAFFIC, RunSpec,
               SpecError, describe_entry, run)


def _spec_dict(src: str) -> dict:
    if src.strip().startswith("{"):
        return json.loads(src)
    with open(src) as fh:
        return json.load(fh)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spec", default=None,
                    help="spec JSON: a file path or an inline object")
    ap.add_argument("--list", action="store_true",
                    help="print every registered key with its description "
                         "and whether the card is usable, and exit")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the resolved spec JSON and exit (no run)")
    ap.add_argument("--csv", action="store_true",
                    help="emit name,us_per_call,derived rows instead of "
                         "the JSON report")
    top = ap.add_argument_group("spec overrides")
    top.add_argument("--protocol", choices=sorted(PROTOCOLS.keys()))
    top.add_argument("--engine", choices=["auto"] + sorted(ENGINES.keys()))
    top.add_argument("--device", choices=("cuda", "cpu"),
                     help="where to run (default: the card)")
    top.add_argument("--n", type=int)
    top.add_argument("--seed", type=int)
    top.add_argument("--memory-budget-mb", type=int)
    topo = ap.add_argument_group("topology")
    topo.add_argument("--topology", choices=sorted(TOPOLOGIES.keys()))
    topo.add_argument("--k", type=int)
    topo.add_argument("--max-delay", type=int)
    topo.add_argument("--beta", type=float)
    tr = ap.add_argument_group("traffic")
    tr.add_argument("--traffic", choices=sorted(TRAFFIC.keys()))
    tr.add_argument("--messages", type=int)
    tr.add_argument("--rate", type=float)
    dyn = ap.add_argument_group("dynamics")
    dyn.add_argument("--dynamics", choices=sorted(SCENARIOS.keys()))
    dyn.add_argument("--n-adds", type=int)
    dyn.add_argument("--n-rms", type=int)
    dyn.add_argument("--n-crashes", type=int)
    win = ap.add_argument_group("window")
    win.add_argument("--window", type=int)
    win.add_argument("--seg-len", type=int)
    win.add_argument("--horizon", type=int)
    win.add_argument("--collect", choices=("auto", "full", "aggregate"))
    met = ap.add_argument_group("metrics")
    met.add_argument("--oracle", action="store_true", default=None,
                     help="happens-before oracle check on the trace")
    return ap


# (args attr, spec section, spec field); None section = top level
_FLAG_MAP = [
    ("protocol", None, "protocol"), ("engine", None, "engine"),
    ("device", None, "device"), ("n", None, "n"), ("seed", None, "seed"),
    ("memory_budget_mb", None, "memory_budget_mb"),
    ("topology", "topology", "kind"), ("k", "topology", "k"),
    ("max_delay", "topology", "max_delay"), ("beta", "topology", "beta"),
    ("traffic", "traffic", "kind"), ("messages", "traffic", "messages"),
    ("rate", "traffic", "rate"),
    ("dynamics", "dynamics", "kind"), ("n_adds", "dynamics", "n_adds"),
    ("n_rms", "dynamics", "n_rms"), ("n_crashes", "dynamics", "n_crashes"),
    ("window", "window", "window"), ("seg_len", "window", "seg_len"),
    ("horizon", "window", "horizon"), ("collect", "window", "collect"),
    ("oracle", "metrics", "oracle"),
]


def spec_from_args(args: argparse.Namespace) -> RunSpec:
    d: dict = _spec_dict(args.spec) if args.spec else {}
    for attr, section, fld in _FLAG_MAP:
        value = getattr(args, attr)
        if value is None:
            continue
        if section is None:
            d[fld] = value
        else:
            d.setdefault(section, {})[fld] = value
    return RunSpec.from_dict(d)


def print_registries() -> None:
    """Every registered key on every axis with its one-line description,
    then whether the port's CUDA kernels can run here."""
    for name, registry in (("protocols", PROTOCOLS), ("engines", ENGINES),
                           ("topologies", TOPOLOGIES), ("traffic", TRAFFIC),
                           ("scenarios (dynamics kinds)", SCENARIOS)):
        print(f"{name}:")
        for key in sorted(registry.keys()):
            desc = describe_entry(registry.get(key))
            print(f"  {key:<16} {desc}" if desc else f"  {key}")
    ok, note = cuda_available()
    print("devices:")
    print(f"  {'cuda':<16} hand-written sm_90a kernels, the default "
          f"[{'available' if ok else 'UNAVAILABLE'}: {note}]")
    print(f"  {'cpu':<16} plain PyTorch versions of every kernel "
          "[available]")


def report_csv_rows(rep) -> list:
    tag = f"proto={rep.spec.protocol},engine={rep.engine},n={rep.n}"
    us = rep.wall_seconds * 1e6
    rows = [(f"api/delivered_frac/{tag}", us, rep.delivered_frac),
            (f"api/mean_latency/{tag}", us, rep.mean_latency),
            (f"api/sent_messages/{tag}", us, float(rep.stats.sent_messages))]
    rows += [(f"api/{key}/{tag}", us, float(v))
             for key, v in sorted(rep.extras.items())
             if isinstance(v, (int, float))]
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        print_registries()
        return 0
    try:
        spec = spec_from_args(args)
        if args.dump_spec:
            print(json.dumps(spec.validate().to_dict(), indent=2))
            return 0
        rep = run(spec)
    except (SpecError, DeviceUnavailableError, FileNotFoundError,
            json.JSONDecodeError, TypeError) as exc:
        # TypeError: a JSON spec with a wrongly-typed field value
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.csv:
        for name, us, derived in report_csv_rows(rep):
            print(f"{name},{us:.2f},{derived:.3f}")
    else:
        print(json.dumps(rep.to_dict(), indent=2))
    if rep.oracle is not None and not rep.oracle.ok:
        print(f"oracle FAILED: {rep.oracle.summary()}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
