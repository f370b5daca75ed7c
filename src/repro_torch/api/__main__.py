"""``python -m repro_torch.api`` — run a RunSpec from JSON or flags.

Spec sources compose left to right: section defaults, then ``--spec``
JSON (a file path or an inline JSON object, e.g. a JAX package spec's
``to_dict()``), then individual flag overrides.  The report prints as
JSON on stdout (``--csv`` switches to ``name,us_per_call,derived``
rows).  Runs on the card unless ``--device cpu``.

    python -m repro_torch.api --protocol pc --engine vec --n 256 \\
        --dynamics churn --messages 12 --oracle
    python -m repro_torch.api --serve --n 1024 --arrivals bursty \\
        --rate 16 --messages 4000 --window 256 --provenance 64 \\
        --audit fail --trace-out serve_trace.json
    python -m repro_torch.api --device cpu --engine sharded --devices 2 \
        --n 256 --topology kregular --k 6 --traffic poisson --rate 2 \
        --messages 30 --window 24 --collect full --oracle
    python -m repro_torch.api --device cpu --n 256 --dynamics churn \
        --messages 12 --oracle --crossval
    python -m repro_torch.api --protocol vc --engine exact --n 100
    python -m repro_torch.api --spec experiment.json
    python -m repro_torch.api --list            # registry keys
"""

from __future__ import annotations

import argparse
import json
import sys

from ..backend import DeviceUnavailableError, cuda_available
from . import (ADMISSION, ARRIVALS, AUDIT, ENGINES, OPS_SINKS, PROTOCOLS,
               SAMPLERS, SCENARIOS, SINKS, TOPOLOGIES, TRAFFIC, RunSpec,
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
    sh = ap.add_argument_group("shard")
    sh.add_argument("--devices", type=int,
                    help="ranks for engine 'sharded' (default: the "
                         "process group's, 1 without one); above 1 the "
                         "run starts them itself, one card a rank (NCCL) "
                         "or CPU ranks over gloo with --device cpu")
    sh.add_argument("--scan", choices=("auto", "on", "off"),
                    help="segment loop for engine 'sharded': deferred "
                         "exchange, fused reduction and fast body (on, "
                         "the auto default) or per-round stepping (off)")
    sh.add_argument("--profile", action="store_true", default=None,
                    help="record per-segment host times (engine "
                         "'sharded'; totals land in the report extras)")
    lv = ap.add_argument_group("live serving (mode='live')")
    lv.add_argument("--serve", action="store_true",
                    help="run as an open-loop service (mode='live'): an "
                         "arrival process feeds a bounded ingest queue, "
                         "an admission policy micro-batches it into the "
                         "streaming engine each segment; --rate/"
                         "--messages then describe the offered load")
    lv.add_argument("--arrivals", choices=sorted(ARRIVALS.keys()),
                    help="open-loop arrival process (live mode)")
    lv.add_argument("--admission", choices=sorted(ADMISSION.keys()),
                    help="admission policy against the window-occupancy "
                         "backpressure signal (live mode)")
    lv.add_argument("--queue-cap", type=int,
                    help="bounded ingest queue length; overflow is "
                         "tail-dropped into the shed count (live mode)")
    lv.add_argument("--admit-cap", type=int,
                    help="max admissions per simulated round "
                         "(live.per_round_cap; default auto from --rate)")
    lv.add_argument("--slo-p99", type=float,
                    help="p99 rounds-to-delivery SLO target; the report's "
                         "serve_slo_ok says whether it was met")
    met = ap.add_argument_group("metrics")
    met.add_argument("--oracle", action="store_true", default=None,
                     help="happens-before oracle check on the trace")
    met.add_argument("--crossval", action="store_true", default=None,
                     help="replay on the exact engine and compare")
    obs = ap.add_argument_group("observability")
    obs.add_argument("--trace-out", metavar="PATH",
                     help="write structured trace spans as Perfetto-"
                          "loadable Chrome trace JSON (implies span "
                          "recording)")
    obs.add_argument("--metrics-out", metavar="PATH",
                     help="write the run's latency histogram / gauges / "
                          "counters through the --sink writer")
    obs.add_argument("--sink", choices=sorted(SINKS.keys()),
                     help="metrics sink format for --metrics-out "
                          "(default jsonl)")
    obs.add_argument("--spans", action="store_true", default=None,
                     help="record trace spans even without --trace-out "
                          "(kept on report.obs.spans)")
    fr = ap.add_argument_group("flight recorder")
    fr.add_argument("--provenance", type=int, metavar="RATE",
                    help="sample 1-in-RATE application broadcasts and "
                         "record their full lifecycle (submit/admit/"
                         "activate/deliver/retire); exported as "
                         "provenance JSONL records and per-message "
                         "Perfetto tracks")
    fr.add_argument("--sampler", choices=sorted(SAMPLERS.keys()),
                    help="provenance sampling policy (default hash: "
                         "deterministic splitmix64 of origin+round)")
    fr.add_argument("--audit", choices=sorted(AUDIT.keys()),
                    help="online causality auditor over the sampled "
                         "records: log (count violations) or fail "
                         "(raise on the first); needs --provenance")
    fr.add_argument("--ops-out", metavar="PATH",
                    help="stream per-tick ops gauges to PATH through "
                         "--ops-sink (live mode)")
    fr.add_argument("--ops-sink", choices=sorted(OPS_SINKS.keys()),
                    help="ops stream format for --ops-out "
                         "(default prometheus)")
    fr.add_argument("--ops-every", type=int, metavar="N",
                    help="publish ops gauges every N ticks (default 1)")
    fr.add_argument("--watch", action="store_true", default=None,
                    help="live terminal dashboard on stderr (plain "
                         "line-per-tick records when not a TTY)")
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
    ("devices", "shard", "devices"), ("scan", "shard", "scan"),
    ("profile", "shard", "profile"),
    ("arrivals", "live", "arrivals"), ("admission", "live", "admission"),
    ("queue_cap", "live", "queue_cap"),
    ("admit_cap", "live", "per_round_cap"),
    ("slo_p99", "live", "slo_p99"),
    ("oracle", "metrics", "oracle"), ("crossval", "metrics", "crossval"),
    ("trace_out", "obs", "trace_out"),
    ("metrics_out", "obs", "metrics_out"),
    ("sink", "obs", "sink"), ("spans", "obs", "spans"),
    ("provenance", "obs", "provenance"), ("sampler", "obs", "sampler"),
    ("audit", "obs", "audit"), ("ops_out", "obs", "ops_out"),
    ("ops_sink", "obs", "ops_sink"), ("ops_every", "obs", "ops_every"),
    ("watch", "obs", "watch"),
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
    if args.serve:
        d["mode"] = "live"
        # under --serve, --rate/--messages describe the offered load,
        # not a pre-scripted traffic schedule
        tr = d.get("traffic", {})
        live = d.setdefault("live", {})
        for fld in ("rate", "messages"):
            if fld in tr:
                live.setdefault(fld, tr.pop(fld))
    return RunSpec.from_dict(d)


def print_registries() -> None:
    """Every registered key on every axis with its one-line description,
    then whether the port's CUDA kernels can run here."""
    for name, registry in (("protocols", PROTOCOLS), ("engines", ENGINES),
                           ("topologies", TOPOLOGIES), ("traffic", TRAFFIC),
                           ("scenarios (dynamics kinds)", SCENARIOS),
                           ("arrivals (live mode)", ARRIVALS),
                           ("admission (live mode)", ADMISSION),
                           ("sinks (--metrics-out formats)", SINKS),
                           ("samplers (--provenance policies)", SAMPLERS),
                           ("audit (--audit modes)", AUDIT),
                           ("ops sinks (--ops-out formats)", OPS_SINKS)):
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
        on_tick = None
        if args.serve:
            tick_no = [0]

            def on_tick(info):
                tick_no[0] += 1
                if tick_no[0] % 16 == 0:
                    print(f"  serve: t={info['t']} "
                          f"admitted={info['admitted_total']} "
                          f"queue={info['queue']} live={info['live']} "
                          f"shed={info['shed']}", file=sys.stderr)
        rep = run(spec, on_tick=on_tick)
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
    if rep.crossval_ok is False:
        print("cross-validation FAILED: engines disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
