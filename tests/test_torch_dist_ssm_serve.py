"""The sharded SSM train cell and the sharded serving path on 4 gloo
ranks, a (2, 2) ("data", "model") mesh, from the JAX package's weights
through ``models.convert`` at float32 (smoke configs cut to one
superblock), against the one-device port:

* mamba2-2.7b's train cell (``launch.dryrun.build_cell``; its SSD scans
  run on their local shards, B and C whole over the heads, their
  gradients summed over the head shards): the loss within 2e-5, every
  gradient within 1e-4 of its leaf's largest and the parameters after
  one AdamW step within 1e-6 where the gradient is firm, as
  ``test_torch_dist_cell.py`` holds yi-6b;
* a decode step with DTensor parameters and the serving caches placed
  by ``cache_specs``, from the one-device prefill's caches:
  recurrentgemma-9b (recurrent states and a windowed KV cache) and
  yi-6b with one KV head, whose cache the policy shards over the
  sequence (context sharding; each shard writes the slot that falls in
  its part).  Logits within 5e-5.

The 4 ranks are spawned once (``tests/torch_dist_ranks.py``).
"""

import numpy as np
import pytest

from torch_dist_cases import check_cell, inputs, one_device
from torch_dist_ranks import run_on_ranks


# decode steps: (arch, KV heads; 0 keeps the smoke config's)
DECODE = [("recurrentgemma-9b", 0), ("yi-6b", 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ssm = inputs("mamba2-2.7b")
    cases = [(name,) + inputs(name, kv) + ({"decode": True},)
             for name, kv in DECODE]
    cases.append(("mamba2-2.7b",) + ssm + ({},))
    got = run_on_ranks(4, tmp_path_factory.mktemp("ssm"), "cell_cases",
                       (cases,), timeout=240.0)
    return got, one_device(*ssm)


def test_ssm_cell_matches_one_device_step(runs):
    got, want = runs
    check_cell(got[-1], want)


@pytest.mark.parametrize("case", range(len(DECODE)),
                         ids=[f"{n}-kv{k}" for n, k in DECODE])
def test_decode_step_matches_one_device(runs, case):
    got = runs[0][case]
    np.testing.assert_allclose(got["got"], got["want"], rtol=5e-5,
                               atol=5e-5)
