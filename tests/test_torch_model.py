"""The port's dense transformer against the JAX model, logits for logits.

Reduced smollm-135m (tied head) and qwen3-4b (qk_norm), float32. One JAX
anchor feeds both packages: the JAX side serves it through its densify
contract, the port through its dequant-GEMM contract (the kernels' plain
versions on the CPU). Prefill (a right-padded prompt with true lengths) and
two decode steps must agree within rtol 1e-4, atol 1e-5 — f32 in both, with
only summation order and transcendental implementations differing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.anchor import materialize as jmaterialize
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.configs import get_reduced as jreduced
from repro.models import get_model as jget_model
from repro.serve.packed_params import make_packed_fn
from repro.serve.packed_params import make_packed_params as jpacked
from repro_torch.configs import get_reduced
from repro_torch.core.anchor import AnchorModel, materialize
from repro_torch.core.mx import MXTensor
from repro_torch.core.formats import get_format
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models.transformer import make_model
from repro_torch.serve.packed_params import make_packed_params

# (anchor, served format); "bf16" = the anchor dequantized to dense weights
CASES = [("mxint8", "bf16"), ("mxint8", "mxint8"), ("mxint8", "mxint4"),
         ("mxfp8", "mxfp8")]
TOL = dict(rtol=1e-4, atol=1e-5)


def _to_port(j) -> AnchorModel:
    """The JAX anchor as port tensors (same codes, no file in between)."""
    q = {k: MXTensor(codes=torch.from_numpy(np.array(t.codes)),
                     scale_exp=torch.from_numpy(np.array(t.scale_exp)),
                     fmt=get_format(t.fmt.name, t.fmt.block_size),
                     block_axis=t.block_axis)
         for k, t in j.quantized.items()}
    raw = {k: torch.from_numpy(np.array(w)) for k, w in j.raw.items()}
    return AnchorModel(quantized=q, raw=raw, fmt_name=j.fmt_name)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("smollm-135m", "qwen3-4b"):
        api = jget_model(jreduced(arch))
        params = jax.jit(api.init_params)(jax.random.PRNGKey(1))
        out[arch] = (api, params, {})
    return out


def _anchor(models, arch, name):
    api, params, cache = models[arch]
    if name not in cache:
        cache[name] = jax.jit(lambda p: jmake(p, JQAT(anchor=name)))(params)
    return cache[name]


@pytest.mark.parametrize("anchor,fmt", CASES)
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-4b"])
def test_prefill_and_decode_logits_match_jax(models, arch, anchor, fmt):
    japi, jparams, _ = models[arch]
    ja = _anchor(models, arch, anchor)
    cfg = get_reduced(arch)
    api = make_model(cfg)
    ta = _to_port(ja)
    if fmt == "bf16":
        jw = jmaterialize(ja, jparams, dtype=jnp.float32)
        jpre, jstep = jax.jit(japi.prefill), jax.jit(japi.serve_step)
        tw, tapi = materialize(ta, dtype=torch.float32), api
    else:
        jw = jpacked(ja, jparams, target_fmt=fmt, dtype=jnp.float32)
        jpre = jax.jit(make_packed_fn(japi, japi.prefill))
        jstep = jax.jit(make_packed_fn(japi, japi.serve_step))
        tw = make_packed_params(ta, target_fmt=fmt, dtype=torch.float32)
        tapi = api.with_qmm(make_qmm())

    rng = np.random.default_rng(2)
    b, s, max_len = 2, 16, 32
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 11], np.int32)          # row 1 right-padded
    jl, jc, jlen = jpre(jw, {"tokens": jnp.asarray(tokens),
                             "lengths": jnp.asarray(lengths)},
                        japi.init_cache(b, max_len))
    tl, tc, tlen = tapi.prefill(
        tw, {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(lengths)},
        tapi.init_cache(b, max_len, device="cpu"))
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jstep(jw, {"tokens": jnp.asarray(nxt)}, jc, jlen)
        tl, tc = tapi.serve_step(tw, {"tokens": torch.from_numpy(nxt)}, tc,
                                 tlen)
        jlen, tlen = jlen + 1, tlen + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for j_blk, t_blk in zip(jc["blocks"], tc["blocks"]):
        np.testing.assert_allclose(t_blk["k"].numpy(), np.asarray(j_blk["k"]),
                                   **TOL)
