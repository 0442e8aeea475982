"""The port's serving roofline (``launch/costmodel.py``) against the JAX
package's, and against what the port's engine measures.

- every ``serve_*`` term, ``total_params`` and ``layer_param_macs`` equal
  the reference's exactly, for every config the port serves, at reduced
  and full width;
- the engine's ``stats()["weight_bytes"]`` per cached tree within rel 0.02
  of ``serve_weight_stream_bytes`` (the analytic term drops norm vectors
  and biases), as ``tests/test_costmodel.py`` holds the JAX engine;
- on the gather read path the engine's ``attn_tokens_read`` equals decode
  ticks x slots x ``serve_attn_read_span`` exactly, dense and paged, and
  ``attn_read_bytes`` is that times ``serve_attn_bytes_per_row(cfg, 1)``.
"""
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import costmodel as jcm
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.anchor import make_anchor, materialize
from repro_torch.core.qat import QATConfig
from repro_torch.launch import costmodel as cm
from repro_torch.models.transformer import init_params, make_model
from repro_torch.serve.engine import ElasticEngine, Request
from repro_torch.serve.packed_params import (make_packed_params,
                                             weight_stream_bytes)

FMTS = ("mxint4", "mxint6", "mxint8", "mxfp8", "mxfp4", "bf16")


def _pair(arch, width):
    return (get_reduced(arch), jget_reduced(arch)) if width == "reduced" \
        else (get_config(arch), jget_config(arch))


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_serve_terms_equal_the_reference(arch, width):
    cfg, jcfg = _pair(arch, width)
    for j in range(cfg.scan_group):
        assert cm.layer_param_macs(cfg, j) == jcm.layer_param_macs(jcfg, j)
    assert cm.total_params(cfg) == jcm.total_params(jcfg)
    assert cm._attn_layers(cfg) == jcm._attn_layers(jcfg)
    for fmt in FMTS:
        for bs in (32, 64):
            assert cm.serve_weight_stream_bytes(cfg, fmt, bs) == \
                jcm.serve_weight_stream_bytes(jcfg, fmt, bs), (fmt, bs)
    for max_len in (48, 512, 4097):
        for layout in ("dense", "paged"):
            for ps in (8, 16):
                span = cm.serve_attn_read_span(cfg, max_len, layout, ps)
                assert span == jcm.serve_attn_read_span(jcfg, max_len,
                                                        layout, ps)
                assert cm.serve_attn_bytes_per_row(cfg, span) == \
                    jcm.serve_attn_bytes_per_row(jcfg, span)
            for n_model in (1, 2, 8):
                kw = dict(max_len=max_len, kv_layout=layout, n_model=n_model)
                assert cm.serve_roofline_terms(cfg, FMTS, **kw) == \
                    jcm.serve_roofline_terms(jcfg, FMTS, **kw)
    with pytest.raises(ValueError, match="n_model"):
        cm.serve_roofline_terms(cfg, FMTS, max_len=64, n_model=0)


def _engine(arch, **kw):
    cfg = get_reduced(arch)
    params = init_params(cfg, 0, device="cpu")
    anchor = make_anchor(params, QATConfig(anchor="mxint8"), device="cpu")
    return cfg, ElasticEngine(make_model(cfg), anchor, batch_slots=2,
                              max_len=48, device="cpu", **kw)


@pytest.mark.parametrize("arch", list_archs())
def test_weight_stream_bytes_match_packed_trees(arch):
    """The engine's cached trees; for llava, which the engine refuses
    (ROADMAP C.10), the same packed trees built directly. A hybrid stack's
    Mamba leaves the reference's term leaves out are added back
    (``mamba_leaf_bytes``)."""
    fmts = ("mxint4", "mxint6", "mxint8", "bf16")
    if get_reduced(arch).vision_tokens:
        cfg = get_reduced(arch)
        anchor = make_anchor(init_params(cfg, 0, device="cpu"),
                             QATConfig(anchor="mxint8"), device="cpu")
        measured = {f: weight_stream_bytes(
            materialize(anchor, cfg.compute_dtype) if f == "bf16" else
            make_packed_params(anchor, target_fmt=f,
                               dtype=cfg.compute_dtype)) for f in fmts}
    else:
        cfg, eng = _engine(arch)
        for fmt in fmts:
            eng.weights_for(fmt)
        measured = eng.stats()["weight_bytes"]
    for fmt in fmts:
        analytic = cm.serve_weight_stream_bytes(cfg, fmt, block_size=32) \
            + cm.mamba_leaf_bytes(cfg, fmt, block_size=32)
        assert analytic == pytest.approx(measured[fmt], rel=0.02), \
            (fmt, analytic, measured[fmt])
    assert measured["mxint4"] < measured["mxint8"] < measured["bf16"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_attn_bytes_match_engine_counters(layout):
    kw = {"kv_layout": layout}
    if layout == "paged":
        kw.update(kv_page_size=8, attn_impl="gather")
    cfg, eng = _engine("smollm-135m", **kw)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab, 8).astype(np.int32),
                    max_new=3) for i in range(3)]
    eng.generate(reqs, fmt_override="mxint8")
    decode_ticks = sum(t["decode"] for t in eng.tick_trace)
    assert decode_ticks > 0
    span = cm.serve_attn_read_span(cfg, 48, layout, kv_page_size=8)
    st = eng.stats()
    assert st["attn_tokens_read"] == decode_ticks * eng.slots * span
    assert st["attn_read_bytes"] == \
        st["attn_tokens_read"] * cm.serve_attn_bytes_per_row(cfg, 1)
