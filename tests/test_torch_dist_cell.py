"""The DTensor train cell (``launch.dryrun.build_cell``) on 4 gloo
ranks, a (2, 2) ("data", "model") mesh, against the one-device port
step, from the JAX package's weights through ``models.convert`` at
float32, on the yi-6b smoke config cut to two layers:

* the loss within 2e-5 and every gradient within 1e-4 of its leaf's
  largest, the tolerances of the port's training parity, and the
  parameters after one AdamW step (ZeRO-1 moments) within 1e-6 where
  the gradient is firm;
* ``seq_shard`` on, and fsdp parameters with ``compute_policy="tp"``,
  giving the same;
* a dimension split over ("data", "model") jointly lands data-major:
  rank (i, j) holds rows [(2 i + j) r, (2 i + j + 1) r), as JAX's joint
  axis splits it.

The 4 ranks are spawned once (``tests/torch_dist_ranks.py``); the
hybrid and MoE families are in ``test_torch_dist_families.py``.
"""

import pytest

from torch_dist_cases import check_cell, inputs, one_device
from torch_dist_ranks import run_on_ranks


CASES = [("yi-6b", {}), ("yi-6b", {"seq_shard": True}),
         ("yi-6b", {"policy": "fsdp", "compute_policy": "tp"})]
WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yi = inputs("yi-6b")
    cases = [("yi-6b",) + yi + (opts,) for _, opts in CASES]
    cases.append(("joint", None, None, None, None))
    got = run_on_ranks(WORLD, tmp_path_factory.mktemp("cell"), "cell_cases",
                       (cases,), timeout=240.0)
    return got, one_device(*yi)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{'-'.join(o) or 'plain'}"
                              for n, o in CASES])
def test_cell_matches_one_device_step(runs, case):
    got, want = runs
    check_cell(got[case], want)


def test_joint_axis_splits_data_major(runs):
    rows = runs[0][-1]                   # each rank's rows, in rank order
    per = 4 * WORLD // WORLD
    for rank, mine in enumerate(rows):
        assert mine == [3 * r for r in range(rank * per, (rank + 1) * per)]
