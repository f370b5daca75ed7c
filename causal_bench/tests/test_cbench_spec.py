"""``BENCHMARK.json`` keeps the benchmark's contract, and every name in
it leads to its file: each cell's configuration and mix, each metric's
reader, each roofline's counts."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from causal_bench.harness.readers import Context
from causal_bench.harness.spec import (BENCH_DIR, ROOT, load_cell,
                                       load_metric, load_roofline)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = 24
    allowed = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert allowed <= 43200


def test_names_units_and_lines():
    named = BENCH["configs"] + BENCH["workloads"] + METRICS
    assert all(NAME.match(x["name"]) for x in named)
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert _line(x["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16


def test_metrics_keep_the_contract():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m
        for cell in m.get("workloads", CELLS):
            moved = [x for x in BENCH["end_to_end"] if x["name"] == m["moves"]]
            assert cell in moved[0].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    spec = load_cell(cell)
    assert spec.config["name"] == spec.cell["config"]
    assert (BENCH_DIR / "drivers" / f"{spec.config['driver']}.py").is_file()
    assert {m["name"] for m in spec.end_to_end} > {"setup_s"}
    assert spec.per_layer
    assert spec.cell["chips"] in (1, 4)
    for m in spec.end_to_end + spec.per_layer:
        assert callable(load_metric(m["name"]).read)


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.parts[len(ROOT.parts)] == "causal_bench"
        body = json.loads(path.read_text())
        assert body["reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_rooflines_load():
    for m in METRICS:
        mod = load_metric(m["name"])
        if hasattr(mod, "ROOFLINE"):
            rl = load_roofline(mod.ROOFLINE)
            assert rl.KERNELS and rl.LAUNCH_KERNEL and len(rl.WRAPPER) == 2


def test_readers_leave_out_what_is_not_there():
    """A reader with nothing to read returns None (no trace, no spans,
    no ticks), never 0."""
    ctx = Context(setup_s=1.5, wall_s=2.0, reps=[])
    for m in METRICS:
        v = load_metric(m["name"]).read(ctx)
        assert v is None or m["name"] == "setup_s"


def test_tick_p95_is_nearest_rank():
    from causal_bench.drivers._judge import Rep
    rep = Rep(t0_ns=0, t1_ns=1, work={}, offered=0, rounds=0, out={},
              tick_ns=np.arange(1, 101, dtype=np.int64) * 1_000_000)
    reader = load_metric("tick_ms_p95")
    assert reader.UNTRACED
    ctx = Context(setup_s=0, wall_s=1, reps=[], untraced=[rep])
    assert reader.read(ctx) == 95.0
    assert reader.read(Context(setup_s=0, wall_s=1, reps=[rep])) is None
