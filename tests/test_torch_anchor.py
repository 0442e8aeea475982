"""Anchor checkpoints across the two packages, held code for code.

The JAX package builds an anchor from a reduced qwen3-4b and writes it with
its ``save_anchor``; the port's ``load_anchor`` reads that directory, and
its ``convert`` to every lower same-kind format must equal JAX ``convert``
bit for bit. The port's own ``make_anchor`` on the carried-over parameters
must equal JAX's, its packed serving trees must hold JAX's bytes, and its
``save_anchor`` / ``load_anchor`` must round-trip.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import convert as jconvert, make_anchor as jmake
from repro.core.formats import get_format as jformat
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.packed_params import (PackedInt4Leaf as JPacked4,
                                       make_packed_params as jpacked)
from repro_torch.checkpoint.anchor_ckpt import load_anchor, save_anchor
from repro_torch.configs import get_reduced
from repro_torch.core.anchor import convert, make_anchor, storage_bytes
from repro_torch.core.formats import get_format
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.serve.packed_params import (PackedInt4Leaf,
                                             make_packed_params)

ANCHORS = {"mxint8": ["mxint7", "mxint6", "mxint5", "mxint4", "mxint3",
                      "mxint2"],
           "mxfp8": ["mxfp7", "mxfp6", "mxfp5", "mxfp4"]}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX params, anchors at bs 32 (and an mxint8 anchor at bs 16), each
    written by the JAX package's save_anchor."""
    api = jget_model(jreduced("qwen3-4b"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    out = {"params": params, "anchors": {}, "dirs": {}}
    for name, bs in [("mxint8", 32), ("mxfp8", 32), ("mxint8", 16)]:
        anchor = _jit_make(params, name, bs)
        path = str(tmp_path_factory.mktemp(f"{name}_{bs}") / "anchor")
        jsave(path, anchor)
        out["anchors"][name, bs] = anchor
        out["dirs"][name, bs] = path
    return out


# The JAX side runs jitted (one compile per function, not one per op).
def _jit_make(params, name, bs):
    return jax.jit(lambda p: jmake(p, JQAT(anchor=name, block_size=bs)))(
        params)


def _jit_convert(anchor, target, bs=32):
    return jax.jit(lambda a: jconvert(a, jformat(target, bs)))(anchor)


def _flat_np(params):
    return {jax.tree_util.keystr(p): np.asarray(w) for p, w in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _assert_same_anchor(j, t):
    assert t.fmt_name == j.fmt_name
    assert set(t.quantized) == set(j.quantized)
    assert set(t.raw) == set(j.raw)
    for k, jt in j.quantized.items():
        tt = t.quantized[k]
        np.testing.assert_array_equal(np.asarray(jt.codes), tt.codes.numpy())
        np.testing.assert_array_equal(np.asarray(jt.scale_exp),
                                      tt.scale_exp.numpy())
        assert tt.fmt.name == jt.fmt.name and tt.block_axis == jt.block_axis
        assert tt.fmt.block_size == jt.fmt.block_size
    for k, jw in j.raw.items():
        np.testing.assert_array_equal(np.asarray(jw), t.raw[k].numpy())


@pytest.mark.parametrize("name", ["mxint8", "mxfp8"])
def test_load_anchor_reads_the_jax_checkpoint(jax_side, name):
    t = load_anchor(jax_side["dirs"][name, 32], device="cpu")
    _assert_same_anchor(jax_side["anchors"][name, 32], t)
    wq = t.quantized["['blocks'][0]['attn']['wq']"]
    assert wq.codes.shape == (2, 64, 64) and wq.scale_exp.shape == (2, 64, 2)


def test_load_anchor_takes_the_block_size_from_the_shapes(jax_side):
    """The JAX writer records the registry default (32) in index.json even
    for a bs=16 anchor; the port reads the true block size off the leaf
    shapes, so the anchor converts exactly like JAX's in-memory one."""
    j = jax_side["anchors"]["mxint8", 16]
    t = load_anchor(jax_side["dirs"]["mxint8", 16], device="cpu")
    _assert_same_anchor(j, t)
    _assert_same_anchor(_jit_convert(j, "mxint4", 16),
                        convert(t, get_format("mxint4", 16)))


@pytest.mark.parametrize("anchor,target", [(a, t) for a, ts in
                                           ANCHORS.items() for t in ts])
def test_convert_matches_jax_code_for_code(jax_side, anchor, target):
    t = load_anchor(jax_side["dirs"][anchor, 32], device="cpu")
    _assert_same_anchor(_jit_convert(jax_side["anchors"][anchor, 32],
                                     target),
                        convert(t, get_format(target, 32)))


@pytest.mark.parametrize("name", ["mxint8", "mxfp8"])
def test_make_anchor_on_carried_params_matches_jax(jax_side, name):
    params = params_from_numpy(_flat_np(jax_side["params"]),
                               get_reduced("qwen3-4b"), device="cpu")
    t = make_anchor(params, QATConfig(anchor=name), device="cpu")
    _assert_same_anchor(jax_side["anchors"][name, 32], t)


@pytest.mark.parametrize("target", ["mxint8", "mxint6", "mxint4"])
def test_packed_serving_tree_matches_jax(jax_side, target):
    j = jax.jit(lambda a: jpacked(a, jax_side["params"], target_fmt=target,
                                  dtype=jnp.float32))(
        jax_side["anchors"]["mxint8", 32])
    t = make_packed_params(load_anchor(jax_side["dirs"]["mxint8", 32],
                                       device="cpu"),
                           target_fmt=target, dtype=torch.float32)
    is_c = lambda x: hasattr(x, "scale_exp")                # noqa: E731
    jl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(j, is_leaf=is_c)[0]}
    tl = dict(flatten_paths(t))
    assert set(jl) == set(tl)
    for k, jv in jl.items():
        tv = tl[k]
        if isinstance(jv, JPacked4):
            assert isinstance(tv, PackedInt4Leaf) and tv.layout == jv.layout
            assert tv.shape == jv.shape
            np.testing.assert_array_equal(np.asarray(jv.packed),
                                          tv.packed.numpy())
            np.testing.assert_array_equal(np.asarray(jv.scale_exp),
                                          tv.scale_exp.numpy())
        elif is_c(jv):
            np.testing.assert_array_equal(np.asarray(jv.codes),
                                          tv.codes.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_port_save_load_round_trip(jax_side, tmp_path):
    t = load_anchor(jax_side["dirs"]["mxfp8", 32], device="cpu")
    low = convert(t, get_format("mxfp6", 32))
    path = os.path.join(tmp_path, "anchor")
    written = save_anchor(path, low)
    back = load_anchor(path, device="cpu")
    assert back.fmt_name == "mxfp6_e3m2" and written > 0
    assert storage_bytes(back) == storage_bytes(low)
    for k, tt in low.quantized.items():
        assert torch.equal(back.quantized[k].codes, tt.codes)
        assert torch.equal(back.quantized[k].scale_exp, tt.scale_exp)
    for k, w in low.raw.items():
        assert torch.equal(back.raw[k], w)


def test_cuda_default_refuses_without_a_card(jax_side):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_anchor(jax_side["dirs"]["mxint8", 32])
