"""The port's encoder-decoder (whisper-small's ``smoke()`` at float32: a
2-layer bidirectional encoder over 24 frames of ``enc_embeds``, 4
decoder layers with cross attention) on the CPU against the JAX
package's, on JAX's weights loaded by ``models.convert``:

* every leaf mapped, the encoder's ``enc_stack.b0....`` leaves (repeat
  axis in front) included, to and from JAX's leaves;
* forward logits within 5e-5;
* the prefill's logits and caches, the cross (k, v) entries ``b{i}_x``
  included, equal to JAX's prefill; prefill + decode equal to the
  forward within 2e-4;
* one loss-and-gradient evaluation equal to ``jax.value_and_grad``'s
  with remat none and dots;
* a checkpoint the JAX package wrote loaded into a port model, saved
  back in JAX's leaf format and read by the JAX package unchanged;
* no ``enc_embeds``: a ``ValueError`` from the model and the launchers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro_torch.checkpoint import ckpt
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import Model
from repro_torch.models.convert import (port_state, stack_superblocks,
                                        unstack_superblocks)

from torch_family_cases import (check_decode_matches_forward,
                                check_grads_match_jax, forward_pair, inputs,
                                models)

NAME = "whisper-small"


def _jax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def jax_params(tree):
    """The port's tensors as the JAX package's params pytree: nested
    dicts of JAX's stacked leaves, detached."""
    out = {}
    for name, t in stack_superblocks(tree).items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach()
    return out


def test_convert_maps_every_leaf_encoder_included():
    _, params, tm = models(NAME)
    cfg = tm.cfg
    state = port_state(jax.tree.map(np.asarray, params))
    own = dict(tm.named_parameters())
    assert sorted(state) == sorted(own)
    for key, arr in state.items():
        np.testing.assert_array_equal(own[key].detach().numpy(), arr)
    assert len(tm.enc_stack) == cfg.encoder_layers
    assert "enc_norm" in own and "stacks.0.3.b0.xattn.wq" in own
    assert "enc_stack.1.b0.attn.wk" in own
    # to JAX's leaves and back
    jleaves = dict(_jax_leaves(jax.tree.map(np.asarray, params)))
    stacked = stack_superblocks(own)
    assert sorted(stacked) == sorted(jleaves)
    for key, arr in jleaves.items():
        np.testing.assert_array_equal(stacked[key].detach().numpy(), arr)
    back = unstack_superblocks(stacked)
    assert sorted(back) == sorted(own)
    nested = jax_params(own)
    assert (jax.tree.structure(nested)
            == jax.tree.structure(jax.tree.map(np.asarray, params)))


def test_forward_matches_jax():
    _, _, tm = models(NAME)
    want, _, got, aux = forward_pair(NAME, inputs(tm.cfg, 2, 24, seed=3))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    assert aux == 0.0


def test_prefill_caches_match_jax_and_decode_matches_forward():
    jm, params, tm = models(NAME)
    inp = inputs(tm.cfg, 2, 20, seed=4)
    want, jcaches = jm.prefill(params, jnp.asarray(inp["tokens"][:, :12]),
                               enc_embeds=jnp.asarray(inp["enc_embeds"]),
                               pad_to=20)
    got, caches = tm.prefill(torch.from_numpy(inp["tokens"][:, :12]),
                             enc_embeds=torch.from_numpy(inp["enc_embeds"]),
                             pad_to=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    assert len(caches) == len(jcaches) == 1
    for r, block in enumerate(caches[0]):
        assert sorted(block) == sorted(jcaches[0]) == ["b0", "b0_x"]
        for name, cache in block.items():
            for leaf, jleaf in zip(cache, jcaches[0][name]):
                np.testing.assert_allclose(
                    leaf.numpy(), np.asarray(jleaf[r]), rtol=5e-5,
                    atol=5e-5, err_msg=f"{r}/{name}")
    assert caches[0][0]["b0_x"][0].shape == (2, tm.cfg.encoder_seq,
                                             tm.cfg.num_kv_heads,
                                             tm.cfg.head_dim)
    after = check_decode_matches_forward(NAME, inp, 12)
    # decode passes the cross entries through untouched
    for block, first in zip(after[0], caches[0]):
        for a, b in zip(block["b0_x"], first["b0_x"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_grads_match_jax(remat):
    _, _, tm = models(NAME)
    check_grads_match_jax(NAME, inputs(tm.cfg, 2, 16, seed=5), remat)


def test_checkpoint_round_trips_in_jax_leaf_format(tmp_path):
    _, params, tm = models(NAME)
    jax_ckpt.save(str(tmp_path / "j"), 3, {"params": params},
                  meta={"data_step": 3})
    model = Model(tm.cfg, device="cpu", seed=7)
    assert ckpt.load_jax_checkpoint(str(tmp_path / "j"), 3, model) == {
        "data_step": 3}
    for k, v in model.named_parameters():
        assert torch.equal(v, dict(tm.named_parameters())[k]), k
    ckpt.save(str(tmp_path / "t"), 3,
              {"params": jax_params(dict(model.named_parameters()))},
              meta={"data_step": 3})
    assert (sorted(ckpt.restore(str(tmp_path / "t"), 3)[0])
            == sorted(jax_ckpt.restore(str(tmp_path / "j"), 3)[0]))
    back, meta = jax_ckpt.restore(str(tmp_path / "t"), 3,
                                  like={"params": params})
    assert meta == {"data_step": 3}
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), {"params": params}, back)


def test_missing_enc_embeds_raises():
    _, _, tm = models(NAME)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: tm(tokens), lambda: tm.prefill(tokens)):
        with pytest.raises(ValueError, match="enc_embeds"):
            call()
    with pytest.raises(ValueError, match="enc_embeds"):
        serve_launcher.main(["--device", "cpu", "--arch", NAME,
                             "--requests", "1"])
    with pytest.raises(ValueError, match="enc_embeds"):
        train_launcher.main(["--device", "cpu", "--arch", NAME, "--steps",
                             "1", "--seq-len", "8", "--batch", "1"])
