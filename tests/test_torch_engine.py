"""The port's ElasticEngine against the JAX engine on one anchor checkpoint.

The JAX package writes an MXINT8 anchor of a reduced qwen3-4b; the JAX
``ElasticEngine(fused=False)`` serves it, and the port's engine
(``device="cpu"``) serves the same directory after ``load_anchor``. With
more requests than slots (so slots retire and re-admit) and mixed prompt
lengths (several pow2 buckets), greedy token streams must be identical at
mxint8 and mxint4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus

SLOTS, MAX_LEN, MAX_NEW = 2, 48, 6


def _prompts(vocab, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 21)))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("qwen3-4b"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, path


def _port_engine(path, **kw):
    return ElasticEngine(make_model(get_reduced("qwen3-4b")),
                         load_anchor(path, device="cpu"), batch_slots=SLOTS,
                         max_len=MAX_LEN, device="cpu", **kw)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_greedy_streams_equal_the_jax_engine(served, fmt):
    api, params, anchor, path = served
    prompts = _prompts(api.cfg.vocab)
    jeng = JEngine(api, anchor, batch_slots=SLOTS, max_len=MAX_LEN,
                   fused=False, param_template=params)
    want = jeng.generate([JRequest(i, p, MAX_NEW)
                          for i, p in enumerate(prompts)], fmt_override=fmt)
    eng = _port_engine(path)
    got = eng.generate([Request(i, p, MAX_NEW)
                        for i, p in enumerate(prompts)], fmt_override=fmt)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.status is RequestStatus.COMPLETED and r.fmt_used == fmt
               for r in got)
    st = eng.stats()
    assert st["prefills"] == len(prompts) > SLOTS        # slots re-admitted
    assert st["tokens_out"] == len(prompts) * MAX_NEW
    assert st["formats_cached"] == [fmt] and st["nonfinite_logit_rows"] == 0
    assert st["weight_bytes"][fmt] > 0


def test_fused_densify_and_dense_contracts_agree(served):
    """On the CPU the kernel contract (plain f32 versions), the densify
    contract and pre-densified weights compute the same f32 function."""
    api, _, _, path = served
    prompts = _prompts(api.cfg.vocab, n=3, seed=4)
    streams = []
    for kw in ({}, {"fused": False}, {"packed": False}):
        eng = _port_engine(path, **kw)
        out = eng.generate([Request(i, p, 4) for i, p in enumerate(prompts)],
                           fmt_override="mxint4")
        streams.append([r.out_tokens for r in out])
    assert streams[0] == streams[1] == streams[2]


def test_bf16_pseudo_format_and_weight_bytes(served):
    _, _, _, path = served
    eng = _port_engine(path)
    eng.generate([Request(0, np.arange(5, dtype=np.int32), 3)],
                 fmt_override="bf16")
    eng.generate([Request(1, np.arange(5, dtype=np.int32), 3)],
                 fmt_override="mxint4")
    wb = eng.stats()["weight_bytes"]
    assert set(wb) == {"bf16", "mxint4"} and wb["mxint4"] < wb["bf16"]


def test_policy_pins_one_format_per_wave(served):
    _, _, _, path = served
    eng = _port_engine(path)
    reqs = [Request(i, np.arange(4, dtype=np.int32) + i, 3) for i in range(4)]
    eng.generate(reqs)
    assert {r.fmt_used for r in reqs} == {"mxint8"}       # idle -> anchor


def test_oversized_prompt_fails_alone(served):
    _, _, _, path = served
    eng = _port_engine(path)
    reqs = [Request(0, np.zeros(MAX_LEN, np.int32), 3),
            Request(1, np.arange(6, dtype=np.int32), 3)]
    eng.generate(reqs)
    assert reqs[0].status is RequestStatus.FAILED_CAPACITY
    assert "exceeds capacity" in reqs[0].error
    assert reqs[1].status is RequestStatus.COMPLETED
    assert len(reqs[1].out_tokens) == 3


@pytest.mark.parametrize("kw,match", [pytest.param(
    {"mesh": object()}, "needs a mesh with a 'model' axis; got axes ()",
    id="kw0-A.9")])
def test_unported_options_refuse_loudly(served, kw, match):
    """``mesh=`` is ported (tensor-parallel serving): an object with no
    ``model`` axis meets the reference's ValueError."""
    _, _, _, path = served
    with pytest.raises(ValueError) as ei:
        _port_engine(path, **kw)
    assert match in str(ei.value)


def test_guard_is_on_by_default_and_takes_only_the_ports_injector(served):
    _, _, _, path = served
    eng = _port_engine(path, fault_injector=FaultInjector(
        poison_logits={1: 0}))
    assert eng.logit_guard and eng.stats()["logit_guard"]
    with pytest.raises(TypeError, match="FaultInjector"):
        _port_engine(path, fault_injector=object())


def test_sampling_and_missing_card_refuse_loudly(served):
    """Sampled decoding runs (``tests/test_torch_sampling.py`` holds its
    streams against JAX); unknown knobs and a missing card still refuse."""
    _, _, _, path = served
    eng = _port_engine(path, temperature=0.8, top_p=0.95)
    out = eng.generate([Request(0, np.arange(3, dtype=np.int32), 2)],
                       greedy=False)
    assert out[0].status is RequestStatus.COMPLETED
    assert len(out[0].out_tokens) == 2
    assert all(0 <= t < eng.api.cfg.vocab for t in out[0].out_tokens)
    assert eng.stats()["admission_order"] == "fifo"
    with pytest.raises(ValueError, match="admission_order"):
        _port_engine(path, admission_order="lifo")
    with pytest.raises(TypeError,
                       match="unexpected keyword argument 'bogus'"):
        _port_engine(path, bogus=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ElasticEngine(make_model(get_reduced("qwen3-4b")), eng.anchor)
