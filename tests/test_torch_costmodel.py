"""The port's serving roofline (``launch/costmodel.py``) against the JAX
package's, and against what the port's engine measures.

- every ``serve_*`` term, ``total_params`` and ``layer_param_macs`` equal
  the reference's exactly, for every config the port serves, at reduced
  and full width; so do ``stack_macs_per_token``, ``mixer_state_macs``
  and the recurrent-state term of ``hbm_decode`` (``decode_state_bytes``)
  for a config of each family that has one (rwkv6-7b, the encoder-decoder,
  jamba) and a dense one;
- the engine's ``stats()["weight_bytes"]`` per cached tree within rel 0.02
  of ``serve_weight_stream_bytes`` (the analytic term drops norm vectors
  and biases), as ``tests/test_costmodel.py`` holds the JAX engine; the
  leaves a hybrid's or an RWKV stack's term counts otherwise than the tree
  holds them are added back (``mamba_leaf_bytes``, ``rwkv_leaf_bytes``);
- on the gather read path the engine's ``attn_tokens_read`` equals decode
  ticks x slots x ``serve_attn_read_span`` exactly, dense and paged, and
  ``attn_read_bytes`` is that times ``serve_attn_bytes_per_row(cfg, 1)``.
"""
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.shapes import ShapeSpec
from repro.launch import costmodel as jcm
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.anchor import make_anchor, materialize
from repro_torch.core.qat import QATConfig
from repro_torch.launch import costmodel as cm
from repro_torch.models import get_model
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


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b", "qwen3-4b"])
def test_family_terms_equal_the_reference(arch, width):
    """``stack_macs_per_token``, ``mixer_state_macs`` and the state term of
    ``hbm_decode`` (its total less the weight and KV terms, on a one-chip
    mesh) equal the reference's."""
    cfg, jcfg = _pair(arch, width)
    for active in (True, False):
        assert cm.stack_macs_per_token(cfg, active) == \
            jcm.stack_macs_per_token(jcfg, active)
    for s, b in ((1, 1), (1, 128), (4096, 8)):
        assert cm.mixer_state_macs(cfg, s, b) == \
            jcm.mixer_state_macs(jcfg, s, b)
    mesh = jcm.MeshDesc(pod=1, data=1, model=1)
    for b in (1, 128):
        shape = ShapeSpec("d", 4096, b, "decode")
        weights = jcm.active_params(jcfg) * 16 / 8
        kv = 2 * jcm._attn_layers(jcfg) * jcfg.n_kv_heads * jcfg.hd \
            * 4096 * 2 * b
        state = jcm.hbm_decode(jcfg, shape, mesh) - weights - kv
        assert cm.decode_state_bytes(cfg, b) == pytest.approx(
            state, rel=1e-9, abs=1e-3)
    assert (cm.decode_state_bytes(cfg, 1) > 0) == \
        (cfg.family in ("ssm", "hybrid"))


def test_rwkv_leaf_bytes_count_the_packed_mix_leaves_at_32_layers():
    """At 32 layers the lerp vectors are packed (codes and scales), below
    that raw; the residue is 0 at bf16 and for other families."""
    d = 64                                      # reduced: f32, 2 layers
    assert cm.rwkv_leaf_bytes(get_reduced("rwkv6-7b"), "mxint8") == \
        pytest.approx(2 * (2 * d * 64 * (4 - 1 - 1 / 32) + 3 * d * 4
                           + 7 * d * 4))
    big = get_config("rwkv6-7b")                # bf16, 32 layers
    assert cm.rwkv_leaf_bytes(big, "mxint8") == pytest.approx(
        32 * (2 * 4096 * 64 * (2 - 1 - 1 / 32) + 3 * 4096 * 2
              + 7 * 4096 * (1 + 1 / 32)))
    assert cm.rwkv_leaf_bytes(big, "bf16") == 0.0
    assert cm.rwkv_leaf_bytes(get_config("qwen3-4b"), "mxint8") == 0.0


def _engine(arch, **kw):
    cfg = get_reduced(arch)
    params = init_params(cfg, 0, device="cpu")
    anchor = make_anchor(params, QATConfig(anchor="mxint8"), device="cpu")
    return cfg, ElasticEngine(make_model(cfg), anchor, batch_slots=2,
                              max_len=48, device="cpu", **kw)


@pytest.mark.parametrize("arch", list_archs())
def test_weight_stream_bytes_match_packed_trees(arch):
    """The engine's cached trees; for llava and seamless, which the engine
    refuses (ROADMAP C.10, C.12), the same packed trees built directly. A
    hybrid stack's Mamba leaves and an RWKV stack's raw leaves the
    reference's term counts otherwise are added back (``mamba_leaf_bytes``,
    ``rwkv_leaf_bytes``)."""
    fmts = ("mxint4", "mxint6", "mxint8", "bf16")
    cfg = get_reduced(arch)
    if cfg.vision_tokens or cfg.family == "encdec":
        anchor = make_anchor(get_model(cfg).init_params(0, device="cpu"),
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
            + cm.mamba_leaf_bytes(cfg, fmt, block_size=32) \
            + cm.rwkv_leaf_bytes(cfg, fmt, block_size=32)
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
