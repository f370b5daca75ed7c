"""The port's M-RoPE family (qwen2-vl-72b's ``smoke()`` at float32,
sections (4, 2, 2)) on the CPU against the JAX package's, on JAX's
weights loaded by ``models.convert``:

* ``mrope`` equal to JAX's on distinct (t, h, w) position streams, apart
  from ``rope`` there and equal to it when the streams agree;
* forward logits within 5e-5 with the default positions and with an
  image block's (t, h, w) grid followed by text; ``embeds`` in place of
  the tokens' embeddings, and the prefill's logits and caches on such a
  prompt, equal to JAX's;
* prefill + decode equal to the forward within 2e-4 (default
  positions: a decode step's position is its cache slot, as in JAX);
* one loss-and-gradient evaluation equal to ``jax.value_and_grad``'s,
  positions in the batch, with remat none and dots;
* the serve and train launchers on qwen2-vl (tokens, default
  positions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import mrope as jax_mrope
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.layers import mrope, rope

from torch_family_cases import (check_decode_matches_forward,
                                check_grads_match_jax, forward_pair, inputs,
                                models)

NAME = "qwen2-vl-72b"


def vl_positions(b, grid, text):
    """(b, 3, t h w + text) positions: an image block on a (t, h, w) grid
    (stream i its grid index i), then ``text`` tokens at one past the
    block's largest index and on, equal in all three streams."""
    t, h, w = grid
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    image = np.stack([ti.ravel(), hi.ravel(), wi.ravel()])
    start = image.max() + 1
    words = np.broadcast_to(np.arange(start, start + text), (3, text))
    pos = np.concatenate([image, words], axis=1).astype(np.int32)
    return np.broadcast_to(pos, (b,) + pos.shape).copy()


def test_mrope_matches_jax_on_distinct_streams():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 14, 3, 16)).astype(np.float32)
    pos = vl_positions(2, (1, 3, 3), 5)
    assert (pos[:, 1] != pos[:, 2]).any()
    got = mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 2, 2), 1e4)
    want = jax_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    plain = rope(torch.from_numpy(x), torch.from_numpy(pos[:, 0]), 1e4)
    assert float((got - plain).abs().max()) > 1e-2
    same = np.broadcast_to(pos[:, :1], pos.shape).copy()
    np.testing.assert_allclose(
        mrope(torch.from_numpy(x), torch.from_numpy(same), (4, 2, 2),
              1e4).numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 2, 1))


@pytest.mark.parametrize("grid", [None, (2, 3, 4)])
def test_forward_matches_jax(grid):
    """Default positions, and 24 image tokens on a 2 x 3 x 4 grid then 8
    of text."""
    _, _, tm = models(NAME)
    pos = None if grid is None else vl_positions(2, grid, 8)
    inp = inputs(tm.cfg, 2, 32, seed=3, positions=pos)
    want, _, got, _ = forward_pair(NAME, inp)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_embeds_and_prefill_on_an_image_prompt_match_jax():
    jm, params, tm = models(NAME)
    inp = inputs(tm.cfg, 1, 20, seed=6, positions=vl_positions(1, (1, 4, 4),
                                                               4))
    rng = np.random.default_rng(7)
    embeds = np.asarray(params["embed"])[inp["tokens"]]
    embeds[:, :16] = rng.standard_normal((1, 16, tm.cfg.d_model)) * 0.02
    embeds = embeds.astype(np.float32)
    pos = inp["positions"]
    want = jm.forward(params, embeds=jnp.asarray(embeds),
                      positions=jnp.asarray(pos))[0]
    with torch.no_grad():
        got = tm(embeds=torch.from_numpy(embeds),
                 positions=torch.from_numpy(pos))
        text = tm(tokens=torch.from_numpy(inp["tokens"]),
                  positions=torch.from_numpy(pos))
        same = tm(embeds=tm.embed[torch.from_numpy(inp["tokens"]).long()],
                  positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(text, same)
    jlast, jcaches = jm.prefill(params, embeds=jnp.asarray(embeds),
                                positions=jnp.asarray(pos), pad_to=24)
    last, caches = tm.prefill(embeds=torch.from_numpy(embeds),
                              positions=torch.from_numpy(pos), pad_to=24)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=5e-5,
                               atol=5e-5)
    for r, block in enumerate(caches[0]):
        for leaf, jleaf in zip(block["b0"], jcaches[0]["b0"]):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf[r]),
                                       rtol=5e-5, atol=5e-5)


def test_decode_matches_forward():
    _, _, tm = models(NAME)
    check_decode_matches_forward(NAME, inputs(tm.cfg, 2, 20, seed=4), 12)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_train_grads_match_jax_with_positions(remat):
    _, _, tm = models(NAME)
    inp = inputs(tm.cfg, 2, 32, seed=5, positions=vl_positions(2, (2, 3, 4),
                                                               8))
    check_grads_match_jax(NAME, inp, remat)


def test_launchers_take_the_vlm(capsys):
    reqs, _ = serve_launcher.main(["--device", "cpu", "--arch", NAME,
                                   "--requests", "3", "--max-new", "4"])
    assert all(len(r.out_tokens) == 4 for r in reqs)
    loss = train_launcher.main(["--device", "cpu", "--arch", NAME,
                                "--steps", "2", "--seq-len", "16",
                                "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "device cpu" in out
