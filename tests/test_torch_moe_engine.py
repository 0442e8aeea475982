"""The port's engine serving reduced mixtral-8x7b against the JAX engine.

One MXINT8 anchor written by the JAX package (reduced widths: 4 experts,
top-2, capacity 1.25, a sliding window of 32), prompts of 40-60 tokens so
the window bites in prefill, chunks, mixed ticks and decode. Routing
depends on the padded shape (capacity is 1.25 * S * k / E per row), so
equal streams also pin that the port pads bucketed prompts, prefill
chunks, mixed-tick lanes and verify lanes with the reference's tokens.
Every stream must equal the JAX engine's token for token:

- greedy on the dense layout (monolithic bucketed prefill) at mxint8 and
  mxint4;
- greedy on the paged layout under the mixed scheduler (chunks of 16,
  pages of 8, B3/B4's plain versions), with the page and attention-read
  accounting equal;
- self-speculative at k = 4 (mxint4 drafts, mxint8 verify) on the paged
  layout, with the spec counters equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.policy import SpecConfig as JSpec
from repro_torch.configs import get_reduced
from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.policy import SpecConfig

ARCH = "mixtral-8x7b"
LAYOUTS = {
    "dense": dict(batch_slots=2, max_len=80),
    "paged": dict(batch_slots=2, max_len=80, kv_layout="paged",
                  kv_page_size=8, attn_impl="paged_kernel",
                  prefill_chunk=16),
}
SPEC = dict(draft_fmt="mxint4", k=4)


def _to_port(j) -> AnchorModel:
    q = {k: MXTensor(codes=torch.from_numpy(np.array(t.codes)),
                     scale_exp=torch.from_numpy(np.array(t.scale_exp)),
                     fmt=get_format(t.fmt.name, t.fmt.block_size),
                     block_axis=t.block_axis)
         for k, t in j.quantized.items()}
    raw = {k: torch.from_numpy(np.array(w)) for k, w in j.raw.items()}
    return AnchorModel(quantized=q, raw=raw, fmt_name=j.fmt_name)


@pytest.fixture(scope="module")
def served():
    api = jget_model(jreduced(ARCH))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(2))
    qat = JQAT(formats=("mxint4", "mxint6", "mxint8"), anchor="mxint8")
    anchor = jax.jit(lambda p: jmake(p, qat))(params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (40, 52, 60)]
    return api, params, anchor, _to_port(anchor), prompts


def _pair(served, layout, spec=None, fmt="mxint8", max_new=6):
    api, params, anchor, port_anchor, prompts = served
    kw = LAYOUTS[layout]
    jeng = JEngine(api, anchor, fused=False, param_template=params,
                   speculative=None if spec is None else JSpec(**spec), **kw)
    want = jeng.generate([JRequest(i, p, max_new)
                          for i, p in enumerate(prompts)], fmt_override=fmt)
    eng = ElasticEngine(make_model(get_reduced(ARCH)), port_anchor,
                        device="cpu",
                        speculative=None if spec is None
                        else SpecConfig(**spec), **kw)
    got = eng.generate([Request(i, p, max_new)
                        for i, p in enumerate(prompts)], fmt_override=fmt)
    return jeng, want, eng, got


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_dense_greedy_streams_match_jax(served, fmt):
    jeng, want, eng, got = _pair(served, "dense", fmt=fmt)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    assert eng.stats()["attn_tokens_read"] == jeng.stats["attn_tokens_read"]


def test_paged_mixed_streams_match_jax(served):
    jeng, want, eng, got = _pair(served, "paged")
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    stats = eng.stats()
    assert eng.scheduler == "mixed"
    for key in ("attn_tokens_read", "kv_pages_alloc", "kv_pages_freed",
                "kv_pages_hwm"):
        assert stats[key] == jeng.stats[key], key
    assert [(t["prefill_tokens"], t["decode"], t["execs"])
            for t in eng.tick_trace] == \
        [(t["prefill_tokens"], t["decode"], t["execs"])
         for t in jeng.tick_trace]


def test_speculative_streams_match_jax(served):
    jeng, want, eng, got = _pair(served, "paged", spec=SPEC, max_new=10)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    stats = eng.stats()
    assert stats["spec_ticks"] > 0
    for key in ("spec_ticks", "spec_accepted", "spec_rejected",
                "spec_aborts"):
        assert stats[key] == jeng.stats[key], key
