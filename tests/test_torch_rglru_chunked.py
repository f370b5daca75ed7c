"""The arithmetic of ``rglru_scan``'s chunked kernel on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/rglru_scan.cu``) runs
only on the card.  It cuts S into chunks of 16 rows; a lane computes
its chunk's aggregate per column, (D, H) = (1 - the product of the
chunk's a, the chunk's own scan from 0), publishes it, and looks back
over the chunks before it: it composes their aggregates, nearest first,
until it finds one whose inclusive prefix (the state at its end) is
published, which gives its carry.  It runs the recurrence from the carry
and publishes the state at its chunk's end as its own prefix.  How far
back a lane composes depends on the timing of the blocks, so this file
mirrors the arithmetic for any look-back depth — always the next
chunk's prefix, always back to chunk 0, and seeded mixes — and holds
each within the tolerances of ``tests/test_kernels.py`` (float32 2e-5,
bfloat16 2e-2, absolute plus relative) of the port's ``rglru_scan_ref``
and of the JAX package's ``rglru_scan_ref``.  Where the inputs make
every float32 evaluation stray from the exact recurrence (a near 1 with
inputs that are not scaled as the model scales them), it holds the
mirror against float64 instead, beside the references' own errors.

Each part of the mirror names the step of ``rglru_chunk_kernel`` it
mirrors (the loads, the aggregate, the look-back, the recurrence and
the prefix): a change to one of those needs the same change here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

CHUNK = 16      # kScanL of rglru_scan.cu
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def chunked_mirror(a, x, h0, depth, complement=True):
    """The kernel's arithmetic in float32: ``(h, h_last)``.  ``depth(c)``
    is how many aggregates chunk ``c`` composes before it reads a prefix
    (0 to c - 1: chunk 0's prefix is always there).  ``complement=False``
    keeps the product A of a chunk's a in place of D = 1 - A, the form the
    kernel does not use, to show what the complement keeps."""
    # numpy float32 (the same roundings as torch's, less overhead a step)
    a, x = a.float().numpy(), x.float().numpy()
    b, s, w = a.shape
    chunks = -(-s // CHUNK)
    one = np.float32(1)

    def zeros():
        return np.zeros((b, w), np.float32)
    # the loads and the aggregate (D, H), rows in order
    agg = []
    for c in range(chunks):
        big_d, big_h = zeros(), zeros()
        for t in range(c * CHUNK, min(s, (c + 1) * CHUNK)):
            big_h = a[:, t] * big_h + x[:, t]
            if complement:
                big_d = (one - a[:, t]) * (one - big_d) + big_d
            else:
                big_d = one - (one - big_d) * a[:, t]
        agg.append((big_d, big_h))
    h = np.empty((b, s, w), np.float32)
    prefix = [None] * chunks
    for c in range(chunks):
        if c == 0:
            carry = zeros() if h0 is None else h0.float().numpy()
        else:
            # the look-back: (Dacc, Hacc) composes chunks j + 1 .. c - 1,
            # (Dj, Hj) then (Dacc, Hacc) = (Dj + Dacc - Dj Dacc,
            # Hj - Dacc Hj + Hacc); a prefix P enters as P - Dacc P + Hacc
            k = depth(c)
            assert 0 <= k <= c - 1
            acc_d, acc_h = zeros(), zeros()
            j = c - 1
            for _ in range(k):
                dj, hj = agg[j]
                if complement:
                    acc_h = (hj - acc_d * hj) + acc_h
                    acc_d = (dj + acc_d) - dj * acc_d
                else:       # the products themselves, rounded each time
                    acc_h = (one - acc_d) * hj + acc_h
                    acc_d = one - (one - acc_d) * (one - dj)
                j -= 1
            p = prefix[j]
            carry = ((p - acc_d * p) if complement
                     else (one - acc_d) * p) + acc_h
        # the recurrence from the carry; the state at the chunk's end is
        # the prefix published for the chunks after it
        for t in range(c * CHUNK, min(s, (c + 1) * CHUNK)):
            carry = a[:, t] * carry + x[:, t]
            h[:, t] = carry
        prefix[c] = carry
    assert h.dtype == np.float32
    h = torch.from_numpy(h)
    return h, h[:, -1]


def _depths(seed):
    """Look-back depths: the next chunk's prefix, back to chunk 0, and a
    seeded mix."""
    rng = np.random.default_rng(seed)
    return {"next": lambda c: 0,
            "chunk0": lambda c: c - 1,
            "mixed": lambda c: int(rng.integers(0, c))}


def _inputs(rng, b, s, w, h0, dtype, near_one=False, scaled=False):
    """a in (0, 1) (within 1e-4 of 1 with ``near_one``) and x ~ 0.2 N(0,
    1); ``scaled`` multiplies x by sqrt(1 - a^2), as the RG-LRU block
    scales its input (``repro.models.rglru._gates``), which keeps the
    state of a long memory bounded."""
    if near_one:
        a = 1.0 - 1e-4 * rng.random((b, s, w))
    else:
        a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    a = a.astype(np.float32)
    x = rng.standard_normal((b, s, w)) * 0.2
    if scaled:
        x = x * 5 * np.sqrt(1.0 - a.astype(np.float64) ** 2)
    hv = (rng.standard_normal((b, w)) * 0.1).astype(np.float32) if h0 \
        else None
    ta = torch.from_numpy(a).to(TORCH_DT[dtype])
    tx = torch.from_numpy(x.astype(np.float32)).to(TORCH_DT[dtype])
    th0 = None if hv is None else torch.from_numpy(hv)
    return ta, tx, th0


def _float64(a, x, h0):
    """The recurrence step by step in float64 on the same inputs."""
    a, x = a.double(), x.double()
    state = torch.zeros(a[:, 0].shape, dtype=torch.float64) if h0 is None \
        else h0.double()
    h = torch.empty(a.shape, dtype=torch.float64)
    for t in range(a.shape[1]):
        state = a[:, t] * state + x[:, t]
        h[:, t] = state
    return h


def _tol_frac(got, want, tol):
    """The largest |got - want| / (tol + tol |want|): 1 at the edge of the
    tolerance."""
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


CASES = [
    # (b, s, w, h0): S not a multiple of the chunk, S below one chunk,
    # S = 1, h0 on and off, W not a multiple of 4 or of a tile, B > 1
    (1, 37, 8, True),
    (2, 5, 7, False),
    (1, 1, 3, True),
    (3, 64, 4, False),
    (2, 100, 129, True),
    (1, 16, 513, False),
    (1, 8192, 4, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w,h0", CASES)
def test_mirror_matches_refs(b, s, w, h0, dtype):
    rng = np.random.default_rng(1000 + s + w)
    ta, tx, th0 = _inputs(rng, b, s, w, h0, dtype)
    want, want_last = rglru_scan_ref(ta, tx, th0)
    jh, jl = jax_rglru_ref(jnp.asarray(ta.float().numpy()),
                           jnp.asarray(tx.float().numpy()),
                           None if th0 is None else jnp.asarray(th0.numpy()))
    tol = TOL[dtype]
    for name, depth in _depths(s + w).items():
        got, last = chunked_mirror(ta, tx, th0, depth)
        _close(got, want, tol, f"{name} vs port ref")
        _close(last, want_last, tol, f"{name} last vs port ref")
        _close(got, jh, tol, f"{name} vs jax ref")
        _close(last, jl, tol, f"{name} last vs jax ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_a_near_one(dtype):
    """a within 1e-4 of 1 over 8,192 steps, x scaled as the model scales
    it: a memory of ~10^4 steps, where the chunks' products stay within
    2e-3 of 1 and the reassociation has the most to lose."""
    rng = np.random.default_rng(1100)
    ta, tx, th0 = _inputs(rng, 2, 8192, 5, True, dtype, near_one=True,
                          scaled=True)
    want, _ = rglru_scan_ref(ta, tx, th0)
    jh, _ = jax_rglru_ref(jnp.asarray(ta.float().numpy()),
                          jnp.asarray(tx.float().numpy()),
                          jnp.asarray(th0.numpy()))
    assert float(want.abs().max()) > 1.0     # the state did build up
    for name, depth in _depths(7).items():
        got, _ = chunked_mirror(ta, tx, th0, depth)
        _close(got, want, TOL[dtype], name)
        _close(got, jh, TOL[dtype], name)


def test_mirror_a_near_one_unscaled_against_float64():
    """The same a with x not scaled: the state grows to ~40 and crosses 0,
    and every float32 evaluation strays from the exact recurrence by more
    than the float32 tolerance near the crossings — the port's step by
    step reference and the JAX package's associative scan too, so neither
    is the yardstick here.  The mirror, composed back to chunk 0 or in a
    seeded mix, stays within the tolerance of float64 and closer to it
    than the step-by-step reference; the product form A, which the kernel
    does not use, does not."""
    rng = np.random.default_rng(1100)
    ta, tx, th0 = _inputs(rng, 2, 8192, 5, True, "float32", near_one=True)
    exact = _float64(ta, tx, th0)
    tol = TOL["float32"]
    step = _tol_frac(rglru_scan_ref(ta, tx, th0)[0], exact, tol)
    assoc = _tol_frac(jax_rglru_ref(jnp.asarray(ta.numpy()),
                                    jnp.asarray(tx.numpy()),
                                    jnp.asarray(th0.numpy()))[0], exact, tol)
    assert step > 1 and assoc > 1, (step, assoc)
    for name, depth in _depths(7).items():
        got = _tol_frac(chunked_mirror(ta, tx, th0, depth)[0], exact, tol)
        # composing nothing is the step-by-step recurrence itself
        assert got <= (step if name == "next" else 1.0), (name, got, step)
        product = _tol_frac(chunked_mirror(ta, tx, th0, depth,
                                           complement=False)[0], exact, tol)
        assert name == "next" or product > step, (name, product, step)


def test_mirror_is_the_step_scan_with_one_chunk():
    """S <= 16: no carry crosses a chunk, so the mirror is the step by
    step recurrence exactly, as the wrapper's plain version computes it."""
    rng = np.random.default_rng(1200)
    ta, tx, th0 = _inputs(rng, 2, 16, 9, True, "float32")
    got, _ = chunked_mirror(ta, tx, th0, lambda c: 0)
    want, _ = rglru_scan(ta, tx, th0)
    assert torch.equal(got, want)
