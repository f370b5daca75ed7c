"""The port's training substrate on the CPU against the JAX package's:
``SyntheticLM`` batches byte-equal over seeds, shards and steps, and
``prefetch`` keeping their order; the checkpoint's round trip (tensors,
bf16 included, numpy and numbers), retention, atomic commit (a save
that dies leaves no step behind and the last one intact), the shape
and leaf-count checks, the JAX on-disk format in both directions, and a
checkpoint the JAX package wrote loaded into a port model, whose
logits equal the JAX model's at 5e-5."""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import ARCHS as JAX_ARCHS
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM, prefetch
from repro_torch.models import Model


# ------------------------------------------------------------------ #
# data
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2),
                                                   (11, 3, 4)])
def test_synthetic_lm_is_byte_equal_to_jax(seed, shard, num_shards):
    kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=seed,
              shard=shard, num_shards=num_shards, n_modes=7)
    port, ref = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(
        JaxDataConfig(**kw))
    assert port.local_batch == ref.local_batch
    for step in (0, 1, 5, 1000):
        a, b = port.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_keeps_order_and_numpy():
    d = SyntheticLM(DataConfig(64, 8, 2))
    direct = [d.batch(i) for i in range(3, 9)]
    for i, b in enumerate(prefetch(d.iterate(3))):
        assert isinstance(b["tokens"], np.ndarray)
        np.testing.assert_array_equal(b["tokens"], direct[i]["tokens"])
        np.testing.assert_array_equal(b["labels"], direct[i]["labels"])
        if i == len(direct) - 1:
            break


# ------------------------------------------------------------------ #
# checkpoint
# ------------------------------------------------------------------ #
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "stacks.0.1.b0.ln1": torch.randn(5, generator=g)
                       .bfloat16()},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "master": None,
                    "m": {"w": torch.randn(8, 16, generator=g)}},
            "extra": {"ids": np.arange(5, dtype=np.int64), "scale": 2.5}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif a is None:
        assert b is None
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 10, t, meta={"data_step": 40}, shards=2)
    assert os.path.basename(path) == "step_10"
    like = _tree(seed=1)
    got, meta = ckpt.restore(str(tmp_path), 10, like=like)
    assert meta == {"data_step": 40}
    _assert_tree_equal(t, got)
    flat, _ = ckpt.restore(str(tmp_path), 10)
    assert "['params']['stacks.0.1.b0.ln1']" in flat
    assert "['opt']['step']" in flat and len(flat) == 6
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["format"] == 1 and manifest["shards"] == 2
    # largest first, round robin: the two (8, 16) f32 leaves split
    big = [e["shard"] for e in manifest["leaves"] if e["shape"] == [8, 16]]
    assert sorted(big) == [0, 1]


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None and ckpt.available_steps(d) == []
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"x": torch.full((3,), float(s))}, keep=2)
    assert ckpt.available_steps(d) == [4, 5] and ckpt.latest_step(d) == 5
    got, _ = ckpt.restore(d, 5, like={"x": torch.zeros(3)})
    assert got["x"].tolist() == [5.0, 5.0, 5.0]


def test_checkpoint_commit_is_atomic(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.ones(4)})

    class Broken:
        shape = (2,)

        def __array__(self, *a, **kw):
            raise RuntimeError("device lost mid-save")

    with pytest.raises(RuntimeError, match="mid-save"):
        ckpt.save(d, 2, {"x": torch.ones(4), "y": Broken()})
    assert ckpt.available_steps(d) == [1]
    assert sorted(os.listdir(d)) == ["step_1"]       # no temp dir left
    got, _ = ckpt.restore(d, 1, like={"x": torch.zeros(4)})
    assert got["x"].tolist() == [1.0] * 4


def test_checkpoint_restore_checks_shapes_and_leaf_count(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, {"a": torch.zeros(2, 3), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.restore(d, 3, like={"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match=r"\['b'\]"):
        ckpt.restore(d, 3, like={"a": torch.zeros(2, 3), "b": torch.zeros(5)})


def test_checkpoint_format_is_the_jax_packages(tmp_path):
    """The port reads a tree the JAX package saved, and the JAX package
    reads one the port saved: same paths, shapes and values."""
    k = jax.random.PRNGKey(0)
    jt = {"w": jax.random.normal(k, (8, 16)),
          "nested": {"b": jnp.arange(5, dtype=jnp.int32),
                     "scale": jnp.float32(2.5)}}
    jax_ckpt.save(str(tmp_path / "j"), 4, jt, meta={"round": 2})
    like = {"w": torch.zeros(8, 16), "nested": {
        "b": torch.zeros(5, dtype=torch.int32), "scale": np.float32(0)}}
    got, meta = ckpt.restore(str(tmp_path / "j"), 4, like=like)
    assert meta == {"round": 2}
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(jt["w"]))
    np.testing.assert_array_equal(got["nested"]["b"].numpy(),
                                  np.asarray(jt["nested"]["b"]))
    ckpt.save(str(tmp_path / "t"), 4, got, meta=meta)
    back, _ = jax_ckpt.restore(str(tmp_path / "t"), 4, like=jt)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), jt, back)
    assert (sorted(ckpt.restore(str(tmp_path / "t"), 4)[0])
            == sorted(jax_ckpt.restore(str(tmp_path / "j"), 4)[0]))


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mamba2-2.7b"])
def test_jax_written_checkpoint_loads_into_a_port_model(tmp_path, name):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    jm = jax_build_model(replace(JAX_ARCHS[name].smoke(), **kw),
                         remat="none")
    params = jax.jit(lambda key: jm.init(key)[0])(jax.random.PRNGKey(2))
    jax_ckpt.save(str(tmp_path), 9, {"params": params},
                  meta={"data_step": 9})
    model = Model(replace(ARCHS[name].smoke(), **kw), device="cpu", seed=5)
    meta = ckpt.load_jax_checkpoint(str(tmp_path), 9, model)
    assert meta == {"data_step": 9}
    tokens = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _, _, _ = jm.forward(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    with pytest.raises(ValueError, match="no leaf"):
        ckpt.load_jax_checkpoint(str(tmp_path), 9, model, prefix="['opt']")
