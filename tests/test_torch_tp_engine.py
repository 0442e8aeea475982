"""Tensor-parallel serving: the port's ``ElasticEngine(mesh=...)`` at tp = 2.

The JAX package writes an MXINT8 anchor of a reduced smollm-135m, its
projections sharpened (x 8, so greedy decode does more than repeat the last
prompt token); two processes joined in a gloo group (``tests/_torch_dist.py``)
serve it from ``load_anchor`` on a (1, 2) mesh, each holding half the heads,
half of d_ff and half the vocabulary. The reference's own tensor-parallel
engine does not run on this JAX ("Length of device assignment 1 is not equal
to the size of the mesh 2", ``tests/test_mesh_serving.py``), so the oracle
is its stated invariant: greedy streams equal the single-device engine's.
Here they must equal both the port's single-device engine and JAX's
single-device ``ElasticEngine(fused=False)`` (dense; the JAX engine's dense
and paged streams are equal, a reference invariant), on the dense and the
paged layout at mxint8 and mxint4 (split-N leaves repacked per shard). The
sharded model's last-position logits lie within ``LOGIT_TOL`` of
max|logit| of the single-device model's: f32 at these sizes, the two
all-reduces per layer only reorder sums. Without a spawn: the reference's
guards and their messages, eager ticks on a mesh, and a snapshot taken on
the mesh refusing a single-device resume.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.models import get_model as jget_model
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ElasticEngine, Request
from _torch_dist import run_ranks, tp_engine_worker

ARCH = "smollm-135m"
SLOTS, MAX_LEN, MAX_NEW = 2, 48, 6
FMTS = ("mxint8", "mxint4")
LOGIT_TOL = 1e-5          # of max|logit|
PROJ = ("'wq'", "'wk'", "'wv'", "'wo'", "'w_gate'", "'w_up'", "'w_down'")


def _prompts(vocab, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 21)))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced(ARCH))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 8.0 if any(n in jax.tree_util.keystr(p)
                                    for n in PROJ) else x,
        jax.jit(api.init_params)(jax.random.PRNGKey(0)))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    prompts = _prompts(api.cfg.vocab)
    jeng = JEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                   fused=False, param_template=params)
    want = {f: [r.out_tokens for r in jeng.generate(
        [JRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)],
        fmt_override=f)] for f in FMTS}
    return api, params, anchor, path, prompts, want


@pytest.fixture(scope="module")
def ranks(served, tmp_path_factory):
    _, _, _, path, prompts, _ = served
    snap = str(tmp_path_factory.mktemp("snap"))
    return run_ranks(tp_engine_worker, 2, ARCH, path, prompts, MAX_NEW,
                     FMTS, snap), snap


def _single(path, **kw):
    return ElasticEngine(make_model(get_reduced(ARCH)),
                         load_anchor(path, device="cpu"), batch_slots=SLOTS,
                         max_len=MAX_LEN, device="cpu", **kw)


def _streams(eng, prompts, fmt, n=None):
    return [r.out_tokens for r in eng.generate(
        [Request(i, p, MAX_NEW) for i, p in enumerate(prompts[:n])],
        fmt_override=fmt)]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tp2_streams_equal_single_device_and_jax(served, ranks, layout, fmt):
    _, _, _, path, prompts, want = served
    out, _ = ranks
    kw = {"kv_layout": "paged", "kv_page_size": 8} if layout == "paged" \
        else {}
    single = _streams(_single(path, **kw), prompts, fmt)
    assert single == want[fmt]
    for rank in out:
        assert rank["streams"][layout, fmt] == want[fmt]
    assert len({t for s in want[fmt] for t in s}) > len(prompts)


@pytest.mark.parametrize("fmt", FMTS)
def test_tp2_logits_within_tolerance(served, ranks, fmt):
    _, _, _, path, prompts, _ = served
    out, _ = ranks
    eng = _single(path)
    cache = eng._init_cache(1)
    want, _, _ = eng._api_for(fmt).prefill(
        eng.weights_for(fmt),
        {"tokens": torch.from_numpy(prompts[0][None])}, cache)
    want = want.numpy()
    scale = np.abs(want).max()
    for rank in out:
        got = rank["logits"][fmt]
        assert got.shape == want.shape == (1, get_reduced(ARCH).vocab)
        assert np.abs(got - want).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(out[0]["logits"][fmt],
                                  out[1]["logits"][fmt])


def test_tp2_weight_bytes_per_chip_about_half(ranks):
    out, _ = ranks
    for rank in out:
        for layout in ("dense", "paged"):
            st = rank["stats"][layout]
            assert st["mesh"] == "1x2" and st["cuda_graphs"] is False
            assert st["kv_pages_alloc"] == st["kv_pages_freed"]
            for fmt in FMTS:
                ratio = st["weight_bytes_per_chip"][fmt] \
                    / st["weight_bytes"][fmt]
                assert 0.5 <= ratio < 0.56, (layout, fmt, ratio)


def test_tp2_snapshot_resumes_on_the_mesh_only(served, ranks):
    _, _, _, path, prompts, _ = served
    out, snap = ranks
    whole = _streams(_single(path), prompts, FMTS[0], n=3)
    for r, rank in enumerate(out):
        assert rank["snapshot"] is not None
        assert f"model{r}" in rank["snapshot"]
        assert rank["resumed"] == whole
    with pytest.raises(ValueError, match="mesh"):
        _single(path).resume(f"{snap}/model0")


def _mesh(shape, names, group=None):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names,
                group=group)


def _both_raise(jbuild, build):
    with pytest.raises(ValueError) as je:
        jbuild()
    with pytest.raises(ValueError) as pe:
        build()
    assert str(pe.value) == str(je.value)


def test_guards_match_the_reference(served):
    api, params, anchor, path, _, _ = served
    from jax.sharding import Mesh as JMesh
    devs = np.array(jax.devices()[:2])
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN)

    def jeng(mesh, a=api):
        return JEngine(a, anchor, param_template=params, fused=False,
                       mesh=mesh, **kw)

    def peng(mesh, cfg=None):
        return ElasticEngine(make_model(cfg or get_reduced(ARCH)),
                             load_anchor(path, device="cpu"), device="cpu",
                             mesh=mesh, **kw)

    _both_raise(lambda: jeng(JMesh(devs.reshape(1, 2), ("data", "x"))),
                lambda: peng(_mesh((1, 2), ("data", "x"))))
    _both_raise(lambda: jeng(JMesh(devs.reshape(2, 1), ("data", "model"))),
                lambda: peng(_mesh((2, 1), ("data", "model"))))
    bad = dataclasses.replace(jreduced(ARCH), vocab=jreduced(ARCH).vocab - 1)
    _both_raise(lambda: jeng(jmesh(1, 2), jget_model(bad)),
                lambda: peng(_mesh((1, 2), ("data", "model")),
                             dataclasses.replace(get_reduced(ARCH),
                                                 vocab=bad.vocab)))
    with pytest.raises(ValueError, match="dense text stacks only"):
        peng(_mesh((1, 2), ("data", "model")), get_reduced("mixtral-8x7b"))
    with pytest.raises(ValueError, match="process group"):
        peng(_mesh((1, 2), ("data", "model")))
    with pytest.raises(ValueError, match="captured in a CUDA graph"):
        ElasticEngine(make_model(get_reduced(ARCH)),
                      load_anchor(path, device="cpu"), device="cpu",
                      mesh=_mesh((1, 1), ("data", "model")),
                      cuda_graphs=True, **kw)


def test_one_by_one_mesh_serves_the_single_device_streams(served):
    """A (1, 1) mesh takes the sharded path (specs, repack, cut) with no
    collective: the streams are the single-device engine's, packed and
    dense."""
    _, _, _, path, prompts, want = served
    eng = _single(path, mesh=_mesh((1, 1), ("data", "model")))
    for fmt in FMTS:
        assert _streams(eng, prompts, fmt) == want[fmt]
    # the dense pseudo-format: a raw tree, placed by the logical rules
    assert _streams(eng, prompts, "bf16") \
        == _streams(_single(path), prompts, "bf16")
    st = eng.stats()
    assert st["mesh"] == "1x1"
    assert st["weight_bytes_per_chip"] == st["weight_bytes"]
