"""The port's engine on the paged KV layout, with chunked admission and the
mixed scheduler, against the JAX engine on one anchor checkpoint.

The JAX package writes an MXINT8 anchor of a reduced qwen3-4b; the JAX
``ElasticEngine(fused=False)`` serves it and the port's engine
(``device="cpu"``) serves the same directory with the same knobs. Greedy
token streams must be identical, and so must the scheduler's record: the
per-tick (prefill tokens, decode, executables) sequence, the page
accounting and the attention-read accounting. Under ``"paged_kernel"`` the
JAX side runs its Pallas kernels in interpret mode and the port its plain
B3/B4 versions.
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
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus

SLOTS, MAX_LEN, MAX_NEW, PS = 2, 48, 5, 8
PAGED = dict(kv_layout="paged", kv_page_size=PS, attn_impl="paged_kernel")
CONFIGS = {
    "paged-monolithic": PAGED,
    "paged-chunk-mixed": dict(PAGED, prefill_chunk=8, scheduler="mixed"),
    "paged-chunk-sequential": dict(PAGED, prefill_chunk=8,
                                   scheduler="sequential"),
    "dense-chunk": dict(prefill_chunk=8),
}


def _prompts(vocab, seed=3, lens=(21, 5, 13, 30)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("qwen3-4b"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


def _pair(served, prompts, fmt="mxint8", max_new=MAX_NEW, **kw):
    """The same requests through both engines; returns both engines and
    both request lists."""
    api, params, janchor, anchor = served
    kw.setdefault("batch_slots", SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    jeng = JEngine(api, janchor, fused=False, param_template=params, **kw)
    want = jeng.generate([JRequest(i, p, max_new)
                          for i, p in enumerate(prompts)], fmt_override=fmt)
    eng = ElasticEngine(make_model(get_reduced("qwen3-4b")), anchor,
                        device="cpu", **kw)
    got = eng.generate([Request(i, p, max_new)
                        for i, p in enumerate(prompts)], fmt_override=fmt)
    return jeng, want, eng, got


def _trace(tick_trace):
    return [(t["prefill_tokens"], t["decode"], t["execs"]) for t in tick_trace]


ACCOUNTING = ("kv_pages_alloc", "kv_pages_freed", "kv_pages_hwm",
              "kv_total_pages", "kv_cache_bytes", "attn_tokens_read",
              "attn_read_bytes", "admission_requeues", "prefill_chunk")


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_streams_and_accounting_equal_the_jax_engine(served, name, fmt):
    api = served[0]
    jeng, want, eng, got = _pair(served, _prompts(api.cfg.vocab), fmt,
                                 **CONFIGS[name])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    assert _trace(eng.tick_trace) == _trace(jeng.tick_trace)
    st, jst = eng.stats(), jeng.stats
    assert {k: st[k] for k in ACCOUNTING} == {k: jst[k] for k in ACCOUNTING}
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]
    if CONFIGS[name].get("scheduler") == "mixed":
        assert any(t["prefill_chunks"] and t["decode"]
                   for t in eng.tick_trace)
        assert all(t["execs"] <= 1 for t in eng.tick_trace)


# Undersized pools: (knobs, prompt lengths, max_new). kv_num_pages=3 leaves
# 2 allocatable pages, so decoding past position 16 starves both requests;
# 6 pages make the larger holder retire so the smaller completes; 5 pages
# under chunked admission requeue the second request until a retire.
STARVED = {
    "both-retire": (dict(kv_num_pages=3), (8, 8), 12),
    "largest-holder": (dict(kv_num_pages=6, max_len=32), (8, 16), 12),
    "chunk-requeue": (dict(kv_num_pages=5, max_len=32, prefill_chunk=8),
                      (6, 22), 8),
}


@pytest.mark.parametrize("case", list(STARVED))
def test_undersized_pool_ends_like_the_jax_engine(served, case):
    knobs, lens, max_new = STARVED[case]
    prompts = _prompts(served[0].cfg.vocab, seed=5, lens=lens)
    jeng, want, eng, got = _pair(served, prompts, max_new=max_new,
                                 **dict(PAGED, **knobs))
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    st = eng.stats()
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]        # no leak
    assert {k: st[k] for k in ACCOUNTING} == \
        {k: jeng.stats[k] for k in ACCOUNTING}
    failed = [r for r in got if r.status is RequestStatus.FAILED_CAPACITY]
    assert all("KV pool exhausted" in r.error for r in failed)
    if case == "chunk-requeue":
        assert st["admission_requeues"] >= 1 and not failed


def test_kernel_and_gather_modes_give_identical_streams(served):
    """Within the port: B3/B4 (plain versions on the CPU) and the gather
    contract, and the path counters show which one ran."""
    anchor = served[3]
    prompts = _prompts(served[0].cfg.vocab, seed=9)
    streams, counts = {}, {}
    for impl in ("paged_kernel", "gather"):
        eng = ElasticEngine(make_model(get_reduced("qwen3-4b")), anchor,
                            batch_slots=SLOTS, max_len=MAX_LEN, device="cpu",
                            kv_layout="paged", kv_page_size=PS,
                            prefill_chunk=8, attn_impl=impl)
        pa.reset_stats()
        reqs = eng.generate([Request(i, p, MAX_NEW)
                             for i, p in enumerate(prompts)])
        streams[impl] = [r.out_tokens for r in reqs]
        counts[impl] = pa.stats()
        n_layers = eng.api.cfg.n_layers
        decode = [t for t in eng.tick_trace if t["decode"]]
        mixed = sum(1 for t in decode if t["prefill_chunks"])
        key = "kernel" if impl == "paged_kernel" else "gather"
        assert counts[impl][key] == n_layers * (len(decode) - mixed) > 0
        assert counts[impl][key + "_mq"] == n_layers * mixed > 0
    assert streams["paged_kernel"] == streams["gather"]


def test_knobs_resolve_and_refuse_like_the_jax_engine(served):
    anchor = served[3]

    def eng(**kw):
        return ElasticEngine(make_model(get_reduced("qwen3-4b")), anchor,
                             batch_slots=SLOTS, max_len=MAX_LEN,
                             device="cpu", **kw)

    e = eng(kv_layout="paged", prefill_chunk="auto")
    assert (e.attn_impl, e.scheduler, e.prefill_chunk) == \
        ("paged_kernel", "mixed", 16)
    e = eng(prefill_chunk="auto")
    assert (e.attn_impl, e.scheduler, e.prefill_chunk) == \
        ("gather", "mixed", 64)
    assert eng().scheduler == "sequential"
    for kw, msg in (({"scheduler": "mixed"}, "set prefill_chunk"),
                    ({"attn_impl": "paged_kernel"}, "requires kv_layout"),
                    ({"kv_layout": "paged", "prefill_chunk": 12},
                     "multiple of kv_page_size"),
                    ({"prefill_chunk": 4}, "minimum prefill bucket"),
                    ({"kv_layout": "ring"}, "unknown kv_layout")):
        with pytest.raises(ValueError, match=msg):
            eng(**kw)


def test_with_qmm_keeps_the_paged_read_path():
    """Chaining ``with_serving`` then ``with_qmm`` keeps ``attn_impl`` (the
    JAX package's chaining rule), and an unknown path is refused."""
    from repro_torch.kernels.dispatch import make_qmm
    api = make_model(get_reduced("qwen3-4b"))
    assert api.attn_impl == "gather"
    kern = api.with_serving(attn_impl="paged_kernel")
    assert kern.with_qmm(make_qmm("kernel")).attn_impl == "paged_kernel"
    assert kern.with_serving().attn_impl == "gather"
    with pytest.raises(ValueError, match="unknown attn_impl"):
        api.with_serving(attn_impl="flash")
