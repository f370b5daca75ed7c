"""The DTensor train cell (``launch.dryrun.build_cell``) of the hybrid
and MoE families on 4 gloo ranks, a (2, 2) ("data", "model") mesh,
against the one-device port step, from the JAX package's weights
through ``models.convert`` at float32, on the smoke configs cut to one
superblock:

* recurrentgemma-9b (its RG-LRU scans run on their local shards) and
  qwen3-moe (the dispatch on each data shard's rows): the loss within
  2e-5, every gradient within 1e-4 of its leaf's largest and the
  parameters after one AdamW step within 1e-6 where the gradient is
  firm, as ``test_torch_dist_cell.py`` holds yi-6b;
* the MoE routing integers of the data shard's rows equal to the
  one-device routing of the same rows, drops included.

The 4 ranks are spawned once (``tests/torch_dist_ranks.py``).
"""

import numpy as np
import pytest

from torch_dist_cases import LAYERS, check_cell, inputs, one_device
from torch_dist_ranks import run_on_ranks


CASES = ["recurrentgemma-9b", "qwen3-moe-235b-a22b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ins = {name: inputs(name) for name in CASES}
    got = run_on_ranks(4, tmp_path_factory.mktemp("families"), "cell_cases",
                       ([(name,) + ins[name] + ({},) for name in CASES],),
                       timeout=240.0)
    return got, {name: one_device(*ins[name]) for name in CASES}


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASES)
def test_cell_matches_one_device_step(runs, case):
    got, want = runs
    check_cell(got[case], want[CASES[case]])


def test_moe_routing_integers_are_the_rows_own(runs):
    got_all, want_all = runs
    name = "qwen3-moe-235b-a22b"
    got = got_all[CASES.index(name)]["routing"]
    want = want_all[name]["routing"]
    layers = LAYERS[name]
    assert len(want) >= layers and len(got) >= layers
    dropped = 0
    for g, w in zip(got[:layers], want[:layers]):
        rows = g["idx"].shape[0]          # this data shard's batch rows
        assert rows == w["idx"].shape[0] // 2
        for key in ("idx", "order", "rank", "keep"):
            np.testing.assert_array_equal(g[key], w[key][:rows],
                                          err_msg=key)
        dropped += int((~g["keep"]).sum())
    assert dropped > 0, "capacity 1.25 dropped nothing: no drop was tested"
