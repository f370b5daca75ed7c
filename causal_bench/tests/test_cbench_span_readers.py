"""The readers of the windowed engine's inner spans (set-up, finish,
enqueue, wait, fold, the blocking copies) on repetitions made by hand:
each gives its exact value, and nothing where the repetitions hold no
program span, as those of a ``--trace 0`` run (only the cell's own
label around each repetition)."""

from __future__ import annotations

import pytest

from causal_bench.drivers._judge import Rep
from causal_bench.harness.readers import Context
from causal_bench.harness.spec import load_metric

MS = 1_000_000

#: a repetition's program spans as (name, start ms, duration ms)
_SPANS = (
    ("engine.setup", 0, 4),
    ("copy.h2d", 1, 2),
    ("segment.enqueue", 5, 1),
    ("segment.wait", 6, 3),
    ("copy.d2h", 7, 2),
    ("retire.fold", 10, 2),
    ("copy.h2d", 10, 1),
    ("segment.enqueue", 13, 2),
    ("segment.wait", 15, 5),
    ("copy.d2h", 16, 4),
    ("retire.fold", 21, 4),
    ("engine.finish", 26, 6),
    ("copy.d2h", 27, 5),
)


def _rep(label: str, rounds: int, scale: int = 1, program=True) -> Rep:
    spans = [(name, (t0 * MS), (t0 + dur * scale) * MS)
             for name, t0, dur in (_SPANS if program else ())]
    spans.append((label, 0, 40 * MS))
    return Rep(t0_ns=0, t1_ns=40 * MS, work={}, offered=0, rounds=rounds,
               out={}, spans=spans)


def _ctx(reps) -> Context:
    return Context(setup_s=0.0, wall_s=1.0, reps=list(reps))


# metric -> its value over two repetitions, the second's spans twice as
# long, of 16 and 24 rounds
EXPECTED = {
    "engine_setup_ms.batch": (4 + 8) / 2,
    "engine_finish_ms.batch": (6 + 12) / 2,
    "segment_enqueue_ms.batch": (1 + 2 + 2 + 4) / 4,
    "segment_enqueue_ms.live": (1 + 2 + 2 + 4) / 4,
    "segment_wait_ms.batch": (3 + 5 + 6 + 10) / 4,
    "segment_wait_ms.live": (3 + 5 + 6 + 10) / 4,
    "retire_fold_ms.live": (2 + 4 + 4 + 8) / 4,
    "blocking_copies_per_round.batch": 10 / 40,
    "blocking_copies_per_round.live": 10 / 40,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_spans(name):
    label = "LiveLoop" if name.endswith(".live") else "execute_windowed"
    reps = [_rep(label, 16), _rep(label, 24, scale=2)]
    assert load_metric(name).read(_ctx(reps)) == pytest.approx(
        EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_nothing_without_program_spans(name):
    label = "LiveLoop" if name.endswith(".live") else "execute_windowed"
    reps = [_rep(label, 16, program=False), _rep(label, 24, program=False)]
    assert load_metric(name).read(_ctx(reps)) is None
