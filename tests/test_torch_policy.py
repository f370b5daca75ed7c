"""The port's logical axes and sharding policy against the JAX
package's, with no devices (JAX's specs on an ``AbstractMesh``, the
port's on a ``{axis: size}`` mapping):

* ``Model.param_axes()`` equals JAX's axes tree leaf for leaf for all
  ten archs, JAX's stacked leaves (one a superblock in the port) with
  their leading "layers" dropped;
* ``param_specs`` (tp, fsdp, serve2d) and ``opt_specs`` (ZeRO-1, the
  fsdp rules) equal JAX's for all ten archs on the (2, 4), (16, 16) and
  (2, 16, 16) meshes, the stacked leaves' leading None dropped;
* ``batch_spec`` and every ``cache_specs`` entry equal JAX's at
  ``decode_32k`` and ``long_500k``;
* ``placements`` gives one ``Shard`` a mesh dimension (a joint entry on
  each of its dimensions; none on a dimension of one rank) and refuses a
  joint entry out of mesh order; ``named`` maps a spec dict through it.
"""

from functools import lru_cache

import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro.sharding import policy as jpolicy
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import specs as tspecs
from repro_torch.models.convert import _flatten, _port_prefix
from repro_torch.sharding import policy as tpolicy

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@lru_cache(maxsize=None)
def _jax(arch):
    return jspecs.shapes_and_axes(jax_build_model(JAX_ARCHS[arch]))


@lru_cache(maxsize=None)
def _port(arch):
    return tspecs.shapes_and_axes(ARCHS[arch])


def _as_port(jax_tree, shapes, leaf):
    """JAX's tree keyed by the port's names; a stacked leaf's value
    (``leaf(value)``) repeated for each of its superblocks."""
    out = {}
    for path, value in _flatten(jax_tree):
        prefix = _port_prefix(path[0])
        if prefix is None:
            out[".".join(path)] = tuple(value)
            continue
        node = shapes
        for key in path:
            node = node[key]
        for r in range(node.shape[0]):
            out[".".join((prefix, str(r)) + path[1:])] = leaf(tuple(value))
    return out


def _drop_layers(axes):
    assert axes[0] == "layers", axes
    return axes[1:]


def _drop_none(spec):
    assert spec[0] is None, spec
    return spec[1:]


def _is_leaf_tuple(t):
    return isinstance(t, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in t)


def _axes_flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _axes_flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_axes_equal_jax(arch):
    jshapes, jaxes = _jax(arch)
    _, taxes = _port(arch)
    want = {}
    for path, axes in _axes_flat(jaxes):
        prefix = _port_prefix(path[0])
        if prefix is None:
            want[".".join(path)] = tuple(axes)
            continue
        node = jshapes
        for key in path:
            node = node[key]
        for r in range(node.shape[0]):
            want[".".join((prefix, str(r)) + path[1:])] = \
                _drop_layers(tuple(axes))
    assert taxes == want


def _spec_tree_flat(tree, prefix=()):
    from jax.sharding import PartitionSpec
    for key, value in tree.items():
        if isinstance(value, PartitionSpec):
            yield prefix + (key,), tuple(value)
        else:
            yield from _spec_tree_flat(value, prefix + (key,))


def _want_specs(jtree, jshapes):
    out = {}
    for path, spec in _spec_tree_flat(jtree):
        prefix = _port_prefix(path[0])
        if prefix is None:
            out[".".join(path)] = spec
            continue
        node = jshapes
        for key in path:
            node = node[key]
        for r in range(node.shape[0]):
            out[".".join((prefix, str(r)) + path[1:])] = _drop_none(spec)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=["2x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_and_opt_specs_equal_jax(arch, mesh):
    sizes, names = mesh
    am = AbstractMesh(sizes, names)
    tm = dict(zip(names, sizes))
    jshapes, jaxes = _jax(arch)
    tshapes, taxes = _port(arch)
    for pol in ("tp", "fsdp", "serve2d"):
        want = _want_specs(jspecs.param_specs(JAX_ARCHS[arch], jshapes, jaxes,
                                              am, policy=pol), jshapes)
        got = tspecs.param_specs(ARCHS[arch], tshapes, taxes, tm, policy=pol)
        assert got == want, pol
    jopt = jspecs.opt_specs(JAX_ARCHS[arch], jshapes, jaxes, am,
                            master_weights=True)
    topt = tspecs.opt_specs(ARCHS[arch], tshapes, taxes, tm,
                            master_weights=True)
    for field in ("m", "v", "master"):
        assert getattr(topt, field) == _want_specs(getattr(jopt, field),
                                                   jshapes), field
    assert topt.step == tuple(jopt.step) == ()
    assert tpolicy.param_policy(ARCHS[arch]) == \
        jpolicy.param_policy(JAX_ARCHS[arch])


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES, ids=["2x4", "16x16", "2x16x16"])
def test_batch_and_cache_specs_equal_jax(mesh, shape):
    sizes, names = mesh
    am = AbstractMesh(sizes, names)
    tm = dict(zip(names, sizes))
    jshape, tshape = JAX_SHAPES[shape], SHAPES[shape]
    for ndim in (1, 2, 3):
        for div in (True, False):
            assert tpolicy.batch_spec(tm, ndim, div) == \
                tuple(jpolicy.batch_spec(am, ndim, div))
    for arch in sorted(JAX_ARCHS):
        jc, tc = JAX_ARCHS[arch], ARCHS[arch]
        jp = jpolicy.cache_specs(jc, am, jshape.global_batch, jshape.seq_len)
        tp = tpolicy.cache_specs(tc, tm, tshape.global_batch, tshape.seq_len)
        # JAX's factory hands out the raw axes tuple, which its
        # PartitionSpec reads as the name when it holds one
        b_ax = jp["batch_axis"]
        if isinstance(b_ax, tuple) and len(b_ax) == 1:
            b_ax = b_ax[0]
        assert tp["batch_axis"] == b_ax
        for kv in (1, 2, 8, 16, 32):
            for cl in (4096, 32768, 524288, 1500, 7):
                assert tp["attn"](kv, cl) == tuple(jp["attn"](kv, cl))
        for c in (tc.d_model, tc.lru_width or tc.d_model,
                  tc.d_inner + 2 * tc.ssm_state, 7):
            assert tp["conv"](c) == tuple(jp["conv"](c))
            assert tp["lru_h"](c) == tuple(jp["lru_h"](c))
            assert tp["ssm_h"](c) == tuple(jp["ssm_h"](c))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert tpolicy.placements((None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    assert tpolicy.placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert tpolicy.placements(((("pod", "data", "model")),), mesh) == \
        [Shard(0)] * 3
    with pytest.raises(ValueError, match="mesh order"):
        tpolicy.placements((("model", "data"),), mesh)
    # an axis of one rank splits nothing
    assert tpolicy.placements(("data", "model"), {"data": 1, "model": 4}) \
        == [Replicate(), Shard(1)]
    assert tpolicy.named(mesh, {"w": (None, "model")}) == \
        {"w": [Replicate(), Replicate(), Shard(1)]}
