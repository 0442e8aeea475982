"""The port's sharding rules, mesh parsing and packed-tree placement against
the JAX package's.

``spec_for_axes`` on the cases of ``tests/test_infra.py``'s
``test_spec_resolution_divisibility`` and on a grid of shapes, logical axes
and mesh sizes; ``param_axes`` of every dense config (every family:
``tests/test_torch_sharded_train.py``); on a real (1, 2) JAX
mesh (the root conftest pins two host devices), ``packed_param_specs``
against ``packed_param_shardings``, ``repack_splitn_for_tp`` bit for bit,
each rank's ``local_shard`` against the addressable shard JAX places there,
and ``weight_stream_bytes_local``; ``parse_mesh`` and ``make_debug_mesh``.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.launch.mesh import make_debug_mesh as jdebug_mesh
from repro.launch.mesh import parse_mesh as jparse_mesh
from repro.models import get_model as jget_model
from repro.serve.packed_params import make_packed_params as jmake_packed
from repro.serve.packed_params import packed_param_shardings
from repro.serve.packed_params import repack_splitn_for_tp as jrepack
from repro.serve.packed_params import weight_stream_bytes_local as jlocal_bytes
from repro.sharding.rules import DEFAULT_RULES as JRULES
from repro.sharding.rules import LogicalRules as JLogicalRules
from repro.sharding.rules import spec_for_axes as jspec
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.core.mx import MXTensor
from repro_torch.core.tree import flatten_paths
from repro_torch.launch.mesh import Mesh, make_debug_mesh, parse_mesh
from repro_torch.models.transformer import cache_axes, param_axes
from repro_torch.serve.packed_params import (PackedInt4Leaf, local_shard,
                                             make_packed_params,
                                             packed_param_specs,
                                             repack_splitn_for_tp,
                                             weight_stream_bytes_local)
from repro_torch.sharding.rules import (DEFAULT_RULES, LogicalRules,
                                        active_mesh, mesh_sizes, param_specs,
                                        spec_for_axes, use_rules)

DENSE = ("smollm-135m", "qwen3-4b", "starcoder2-3b", "qwen2-72b")
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((4,), ("model",)),
          ((3, 2), ("pod", "model"))]


def _flat(tree, prefix=""):
    """``flatten_paths`` with tuples (axes, specs) as leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


class _FakeMesh:
    """What the reference's ``spec_for_axes`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _mesh(shape, names):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names)


def test_spec_resolution_divisibility():
    """The reference's cases (``tests/test_infra.py``), on the port."""
    fake = _mesh((2, 16, 16), ("pod", "data", "model"))
    rules = LogicalRules(dict(DEFAULT_RULES))
    assert spec_for_axes((64, 32), ("fsdp", "model"),
                         _mesh((1, 1), ("data", "model"))) \
        == ("data", "model")
    s = spec_for_axes((49152, 576), ("vocab", "fsdp"), fake, rules)
    assert s[0] == "model" and s[1] == ("pod", "data")
    assert spec_for_axes((9, 64), ("heads", None), fake, rules)[0] is None
    assert spec_for_axes((16, 16), ("model", "model"), fake, rules) \
        == ("model", None)
    assert spec_for_axes((32,), ("batch",), fake, rules) == (("pod", "data"),)
    assert spec_for_axes((2,), ("batch",), fake, rules) == ("pod",)
    assert DEFAULT_RULES == JRULES


@pytest.mark.parametrize("shape,names", MESHES)
def test_spec_grid_equals_jax(shape, names):
    dims = (1, 2, 3, 4, 6, 8, 9, 12, 16, 32, 48, 576, 49152)
    logical = sorted(DEFAULT_RULES) + [None, "unknown"]
    port, fake = _mesh(shape, names), _FakeMesh(shape, names)
    for d0, d1 in itertools.product(dims, dims[::3]):
        for a0, a1 in itertools.product(logical, logical):
            want = tuple(jspec((d0, d1), (a0, a1), fake,
                               JLogicalRules(dict(JRULES))))
            assert spec_for_axes((d0, d1), (a0, a1), port) == want, \
                ((d0, d1), (a0, a1), shape, names)


def test_active_rules_override_the_default():
    mesh = _mesh((1, 2), ("data", "model"))
    only_data = LogicalRules({"heads": ("data",)})
    assert active_mesh() is None
    with use_rules(mesh, only_data):
        assert active_mesh() is mesh
        assert spec_for_axes((4, 4), ("heads", "mlp"), mesh) == ("data", None)
    assert active_mesh() is None
    assert spec_for_axes((4, 4), ("heads", "mlp"), mesh) == ("model", None)


@pytest.mark.parametrize("arch", DENSE)
def test_param_axes_equal_jax(arch):
    want = jget_model(jreduced(arch)).param_axes()
    got = param_axes(get_reduced(arch))
    flat_w = {k.replace('"', "'"): v for k, v in
              ((jax.tree_util.keystr(p), a) for p, a in
               jax.tree_util.tree_flatten_with_path(
                   want, is_leaf=lambda x: isinstance(x, tuple))[0])}
    assert dict(_flat(got)) == flat_w


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cache_axes_equal_jax(layout):
    arch = "qwen3-4b"
    want = jget_model(jreduced(arch)).cache_axes(layout)
    flat_w = {jax.tree_util.keystr(p).replace('"', "'"): a for p, a in
              jax.tree_util.tree_flatten_with_path(
                  want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert dict(_flat(cache_axes(get_reduced(arch), layout))) == flat_w


def test_param_axes_refuse_a_non_dense_stack():
    """``param_axes`` covers every family (the reference's ``block_axes``);
    the sharded training step shards every family over ``model`` and
    refuses, naming the dim, an axis that does not divide a dim its
    forward cuts: reduced rwkv6-7b's 4 heads at ``model`` = 3 (the
    tensor-parallel engine's guard, dense text only:
    ``tests/test_torch_tp_engine.py``)."""
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import make_sharded_train_step
    cfg = get_reduced("mixtral-8x7b")
    assert param_axes(cfg)["blocks"][0]["moe"]["experts"]["w_up"] == (
        None, "experts", "fsdp", "mlp")
    with pytest.raises(ValueError, match="'rwkv heads': 4"):
        make_sharded_train_step(get_model(get_reduced("rwkv6-7b")),
                                _mesh((1, 3), ("data", "model")),
                                AdamWConfig(), {"tokens": (3, 8)})


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """JAX's packed trees of a reduced smollm-135m at mxint8 / mxint4 on a
    (1, 2) mesh (placed, split-N leaves repacked) and the port's from the
    same anchor checkpoint."""
    api = jget_model(jreduced("smollm-135m"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    jm = jdebug_mesh(1, 2)
    port_anchor = load_anchor(path, device="cpu")
    out = {}
    for fmt in ("mxint8", "mxint4"):
        w = jmake_packed(anchor, params, target_fmt=fmt)
        shd = packed_param_shardings(w, api.param_axes(), jm)
        placed = jax.device_put(jrepack(w, shd, 2), shd)
        out[fmt] = (w, shd, placed,
                    make_packed_params(port_anchor, target_fmt=fmt))
    return out


def _jax_leaves(tree):
    is_c = lambda x: hasattr(x, "scale_exp")
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_c)[0]}


def _parts(leaf):
    if isinstance(leaf, MXTensor) or hasattr(leaf, "codes"):
        return {"codes": leaf.codes, "scale_exp": leaf.scale_exp}
    if isinstance(leaf, PackedInt4Leaf) or hasattr(leaf, "packed"):
        return {"packed": leaf.packed, "scale_exp": leaf.scale_exp}
    return {"raw": leaf}


MESH12 = _mesh((1, 2), ("data", "model"))


def _np(t):
    """A tensor as numpy, bf16 widened to f32 (exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_packed_param_specs_equal_jax(trees, fmt):
    _, shd, _, port = trees[fmt]
    specs = dict(_flat(packed_param_specs(
        port, param_axes(get_reduced("smollm-135m")), MESH12)))
    want = _jax_leaves(shd)
    assert set(specs) == set(want)
    n_sharded = 0
    for k, sh in want.items():
        got, exp = _parts(specs[k]), _parts(sh)
        assert set(got) == set(exp), k
        for part in exp:
            assert got[part] == tuple(exp[part].spec), (k, part)
            n_sharded += "model" in str(got[part])
    assert n_sharded > 10


def test_repack_and_local_shards_equal_jax(trees):
    """Bit for bit: the repacked split-N bytes, and each rank's shard of
    every leaf against the shard JAX puts on that rank's device."""
    w, shd, placed, port = trees["mxint4"]
    specs = packed_param_specs(port, param_axes(get_reduced("smollm-135m")),
                               MESH12)
    repacked = repack_splitn_for_tp(port, specs, MESH12)
    jrep = _jax_leaves(jrepack(w, shd, 2))
    n_repacked = 0
    for k, leaf in flatten_paths(repacked):
        for part, t in _parts(leaf).items():
            np.testing.assert_array_equal(
                _np(t), _jnp(_parts(jrep[k])[part]), err_msg=k)
        if isinstance(leaf, PackedInt4Leaf) and not torch.equal(
                leaf.packed, dict(flatten_paths(port))[k].packed):
            n_repacked += 1
    assert n_repacked >= 4     # wq, wk, wv, w_gate, w_up: column-sharded
    jplaced = _jax_leaves(placed)
    for rank in range(2):
        local = dict(flatten_paths(local_shard(repacked, specs, MESH12,
                                               {"data": 0, "model": rank})))
        for k, leaf in local.items():
            for part, t in _parts(leaf).items():
                arr = _parts(jplaced[k])[part]
                shard = next(s for s in arr.addressable_shards
                             if s.device == jax.devices()[rank])
                np.testing.assert_array_equal(_np(t), _jnp(shard.data),
                                              err_msg=(k, part, rank))
                assert t.is_contiguous()


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_weight_stream_bytes_local_equals_jax(trees, fmt):
    _, _, placed, port = trees[fmt]
    specs = packed_param_specs(port, param_axes(get_reduced("smollm-135m")),
                               MESH12)
    local = local_shard(repack_splitn_for_tp(port, specs, MESH12), specs,
                        MESH12, {"data": 0, "model": 0})
    assert weight_stream_bytes_local(local) == jlocal_bytes(placed)


def test_param_specs_of_a_dense_tree():
    cfg = get_reduced("qwen3-4b")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 0, device="cpu")
    specs = param_specs(param_axes(cfg), params, MESH12)
    assert specs["embed"] == ("model", "data")
    assert specs["lm_head"] == ("data", "model")
    blk = specs["blocks"][0]
    assert blk["attn"]["wo"] == (None, "model", "data")
    assert blk["attn"]["q_norm"] == (None, None)
    local = local_shard(params, specs, MESH12, {"data": 0, "model": 1})
    np.testing.assert_array_equal(
        local["blocks"][0]["mlp"]["w_up"].numpy(),
        params["blocks"][0]["mlp"]["w_up"][:, :, cfg.d_ff // 2:].numpy())


@pytest.mark.parametrize("spec", ["1x2", "2X4", "16x16", "1x2x3", "12",
                                  "ax2", "0x2", "1x-1", "x"])
def test_parse_mesh_equals_jax(spec):
    try:
        want = jparse_mesh(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            parse_mesh(spec)
        assert str(ei.value) == str(e)
    else:
        assert parse_mesh(spec) == want


def test_make_debug_mesh_without_a_group():
    m = make_debug_mesh(1, 1)
    assert m.axis_names == ("data", "model")
    assert mesh_sizes(m) == {"data": 1, "model": 1}
    assert m.group is None and m.coord("model") == 0
    with pytest.raises(ValueError, match="must be >= the product"):
        make_debug_mesh(1, 2)
