"""The MXFP rungs through the port's ElasticEngine against the JAX engine.

The JAX package writes an MXFP8 anchor of a reduced smollm-135m, its
projections sharpened (x 8: at the reference's init the residual stream
carries the token's own embedding through every layer, so greedy decode
repeats the last prompt token at every format); the JAX ``ElasticEngine(
fused=False)`` with an MXFP ladder serves it at mxfp8, mxfp6 and mxfp4,
and the port's engine (``device="cpu"``) serves the same directory after
``load_anchor``: greedy streams equal on the dense layout at each rung and
on the paged layout at mxfp4, each rung's weight bytes equal to
``serve_weight_stream_bytes`` as ``tests/test_torch_costmodel.py`` holds
them, and, with the default MXINT ladder, the reference's ``ValueError``.
"""
import jax
import numpy as np
import pytest

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.policy import FormatPolicy as JPolicy
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.launch.costmodel import serve_weight_stream_bytes
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.policy import FormatPolicy

SLOTS, MAX_LEN, MAX_NEW = 2, 48, 6
LADDER = ((32, "mxfp4"), (8, "mxfp6"), (0, "mxfp8"))
FMTS = ("mxfp8", "mxfp6", "mxfp4")
PROJ = ("'wq'", "'wk'", "'wv'", "'wo'", "'w_gate'", "'w_up'", "'w_down'")


def _prompts(vocab, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 21)))
            .astype(np.int32) for _ in range(n)]


def _sharpen(params):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x * 8.0 if any(n in jax.tree_util.keystr(p)
                                    for n in PROJ) else x, params)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("smollm-135m"))
    params = _sharpen(jax.jit(api.init_params)(jax.random.PRNGKey(0)))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxfp8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    prompts = _prompts(api.cfg.vocab)
    jeng = JEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                   fused=False, param_template=params,
                   policy=JPolicy(anchor="mxfp8", ladder=LADDER))
    want = {f: [r.out_tokens for r in jeng.generate(
        [JRequest(i, p, MAX_NEW) for i, p in enumerate(prompts)],
        fmt_override=f)] for f in FMTS}
    return api, params, anchor, path, prompts, want


def _port_engine(path, **kw):
    return ElasticEngine(make_model(get_reduced("smollm-135m")),
                         load_anchor(path, device="cpu"), batch_slots=SLOTS,
                         max_len=MAX_LEN, device="cpu", **kw)


def _serve(eng, prompts, fmt):
    reqs = eng.generate([Request(i, p, MAX_NEW)
                         for i, p in enumerate(prompts)], fmt_override=fmt)
    assert all(r.status is RequestStatus.COMPLETED and r.fmt_used == fmt
               for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("fmt", FMTS)
def test_greedy_streams_equal_the_jax_engine(served, fmt):
    _, _, _, path, prompts, want = served
    eng = _port_engine(path, policy=FormatPolicy(anchor="mxfp8",
                                                 ladder=LADDER))
    assert _serve(eng, prompts, fmt) == want[fmt]
    st = eng.stats()
    assert st["formats_cached"] == [fmt] and st["nonfinite_logit_rows"] == 0
    cfg = get_reduced("smollm-135m")
    assert serve_weight_stream_bytes(cfg, fmt, block_size=32) == \
        pytest.approx(st["weight_bytes"][fmt], rel=0.02)


def test_the_rungs_serve_different_streams(served):
    """The sharpened weights make each rung's rounding show in its
    streams, so equal streams above are the rung's own."""
    want = served[-1]
    assert want["mxfp8"] != want["mxfp6"] != want["mxfp4"]
    assert all(len(set(s)) > 1 for s in want["mxfp8"])


def test_paged_layout_serves_the_dense_streams(served):
    _, _, _, path, prompts, want = served
    eng = _port_engine(path, kv_layout="paged", kv_page_size=8,
                       policy=FormatPolicy(anchor="mxfp8", ladder=LADDER))
    assert _serve(eng, prompts, "mxfp4") == want["mxfp4"]
    st = eng.stats()
    assert st["kv_pages_alloc"] == st["kv_pages_freed"] > 0


@pytest.mark.parametrize("policy", [None, "mxint8", "mxfp8"])
def test_the_default_ladder_refuses_as_the_reference_does(served, policy):
    """An mxfp8 anchor under the default MXINT ladder: both engines raise
    at their first wave, with the same message."""
    api, params, anchor, path, prompts, _ = served
    jkw = {} if policy is None else {"policy": JPolicy(anchor=policy)}
    kw = {} if policy is None else {"policy": FormatPolicy(anchor=policy)}
    jeng = JEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                   fused=False, param_template=params, **jkw)
    with pytest.raises(ValueError) as want:
        jeng.generate([JRequest(0, prompts[0], 2)])
    with pytest.raises(ValueError) as got:
        _port_engine(path, **kw).generate([Request(0, prompts[0], 2)])
    assert str(got.value) == str(want.value)
    assert "cannot slice-and-scale across kinds" in str(got.value)
