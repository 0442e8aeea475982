"""The port's engine serving reduced rwkv6-7b (RWKV6 layers, no attention)
against the JAX engine.

MXINT8 anchors made by the JAX package from the reference's init with the
lerp weights redrawn and the outputs sharpened (``_sharpen``: at the init's
small ``wo`` / ``w_value`` the recurrent state hardly reaches the logits,
greedy streams repeat one token, and a recurrence applied twice would not
show), three prompts of 12, 37 and 80 tokens (one chunk, 37 one-token
chunks, 5 chunks of 16) on the dense layout, served unbucketed (the
reference's rule for a recurrent stack). The port runs its kernel path
(B1/B2's plain versions on the CPU). Token streams must be equal:

- greedy at mxint8 and mxint4 at 2 layers against the JAX engine's fused
  path, and at 32 layers, where the anchor quantizes the ``mix_*`` leaves
  along the layer axis (ROADMAP C.11), against its densify path
  (``fused=False``; its fused path raises there), with the prefill and
  tick counts, the attention-read counts (0 bytes: no attention layer) and
  the cache bytes equal;
- with ``FaultInjector(poison_logits=...)`` plans: a poisoned mxint4 tick
  that escalates and replays (the replay must start from the pre-tick
  ``shift_t`` / ``wkv`` / ``shift_c``, not apply the recurrence twice),
  and a row poisoned at the anchor that retires one request; statuses,
  errors, escalation events equal too;
- preempted mid-wave and resumed on a fresh engine: the uninterrupted
  streams, and the snapshot's state leaves equal to the JAX engine's
  within rtol 1e-4 / atol 1e-5 (``tests/test_torch_model.py``'s).

The refusals (paged layout, chunked admission, the mixed tick and the
verify at the model level, speculation) carry the reference's messages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.runtime.fault import FaultInjector as JFault
from repro.runtime.fault import PreemptionGuard as JGuard
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.policy import SpecConfig as JSpec
from repro_torch.checkpoint import io
from repro_torch.configs import get_reduced
from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector, PreemptionGuard
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.policy import SpecConfig

ARCH = "rwkv6-7b"
KW = dict(batch_slots=2, max_len=96)
PLENS = (12, 37, 80)
GUARD_KEYS = ("faults_detected", "fmt_escalations", "ticks_replayed",
              "quarantined_formats", "request_statuses", "tokens_out")
STATE = ("shift_c", "shift_t", "wkv")


def _to_port(j) -> AnchorModel:
    q = {k: MXTensor(codes=torch.from_numpy(np.array(t.codes)),
                     scale_exp=torch.from_numpy(np.array(t.scale_exp)),
                     fmt=get_format(t.fmt.name, t.fmt.block_size),
                     block_axis=t.block_axis)
         for k, t in j.quantized.items()}
    raw = {k: torch.from_numpy(np.array(w)) for k, w in j.raw.items()}
    return AnchorModel(quantized=q, raw=raw, fmt_name=j.fmt_name)


def _sharpen(params, seed):
    """Lerp weights drawn in (0.1, 0.9), the decay base at -1, ``wo`` and
    ``w_value`` x 40 and the head x 10: every layer's state moves the
    argmax."""
    rng = np.random.default_rng(seed)
    blk = dict(params["blocks"][0])
    for sub in ("rwkv", "cmix"):
        leaves = dict(blk[sub])
        for k, v in leaves.items():
            if k.startswith("mix_"):
                leaves[k] = jnp.asarray(rng.uniform(0.1, 0.9, v.shape),
                                        jnp.float32)
        blk[sub] = leaves
    blk["rwkv"].update(decay_base=blk["rwkv"]["decay_base"] * 0 - 1.0,
                       wo=blk["rwkv"]["wo"] * 40)
    blk["cmix"]["w_value"] = blk["cmix"]["w_value"] * 40
    return dict(params, blocks=[blk], lm_head=params["lm_head"] * 10)


def _serve(layers):
    jcfg = dataclasses.replace(jreduced(ARCH), n_layers=layers)
    api = jget_model(jcfg)
    params = _sharpen(jax.jit(api.init_params)(jax.random.PRNGKey(3)),
                      layers)
    qat = JQAT(formats=("mxint4", "mxint6", "mxint8"), anchor="mxint8")
    anchor = jax.jit(lambda p: jmake(p, qat))(params)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in PLENS]
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=layers)
    return api, params, anchor, _to_port(anchor), prompts, cfg


@pytest.fixture(scope="module")
def served():
    return _serve(2)


@pytest.fixture(scope="module")
def served32():
    out = _serve(32)
    assert "['blocks'][0]['rwkv']['mix_w']" in out[2].quantized
    return out


def _jax(served, plan=None, fused=True, **kw):
    api, params, anchor = served[:3]
    return JEngine(api, anchor, fused=fused, param_template=params,
                   fault_injector=None if plan is None else JFault(**plan),
                   **dict(KW, **kw))


def _port(served, plan=None, **kw):
    return ElasticEngine(
        make_model(served[5]), served[3], device="cpu",
        fault_injector=None if plan is None else FaultInjector(**plan),
        **dict(KW, **kw))


def _reqs(served, cls, max_new=6):
    return [cls(i, p, max_new) for i, p in enumerate(served[4])]


def _streams(reqs):
    return [r.out_tokens for r in reqs]


def _check_streams(served, fmt, fused):
    jeng = _jax(served, fused=fused)
    want = jeng.generate(_reqs(served, JRequest), fmt_override=fmt)
    eng = _port(served)
    got = eng.generate(_reqs(served, Request), fmt_override=fmt)
    assert _streams(got) == _streams(want)
    assert all(len(set(r.out_tokens)) > 2 for r in got)
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    st, js = eng.stats(), jeng.stats
    assert not eng._bucket and not jeng._bucket
    for key in ("ticks", "tokens_out", "attn_tokens_read",
                "attn_read_bytes", "kv_cache_bytes", "kv_bytes_per_slot"):
        assert st[key] == js[key], key
    assert st["attn_read_bytes"] == 0
    # each prompt prefilled at its own length
    assert [t["prefill_tokens"] for t in eng.tick_trace] == \
        [t["prefill_tokens"] for t in jeng.tick_trace]
    assert max(t["prefill_tokens"] for t in eng.tick_trace) == max(PLENS)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_streams_match_jax(served, fmt):
    _check_streams(served, fmt, fused=True)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_streams_match_jax_densify_at_32_layers(served32, fmt):
    _check_streams(served32, fmt, fused=False)


@pytest.mark.parametrize("plan", [
    dict(poison_logits={3: None}, poison_fmt="mxint4"),   # escalate, replay
    dict(poison_logits={4: 1}),                           # retire one row
])
def test_poisoned_wave_matches_jax(served, plan):
    fmt = "mxint4" if plan.get("poison_fmt") else "mxint8"
    jeng = _jax(served, plan)
    want = jeng.generate(_reqs(served, JRequest), fmt_override=fmt)
    eng = _port(served, plan)
    got = eng.generate(_reqs(served, Request), fmt_override=fmt)
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert [r.error for r in got] == [r.error for r in want]
    assert _streams(got) == _streams(want)
    assert [r.fmt_used for r in got] == [r.fmt_used for r in want]
    st, js = eng.stats(), jeng.stats
    for key in GUARD_KEYS:
        assert st[key] == js[key], key
    assert st["escalation_events"] == js["escalation_events"]
    assert st["ticks_replayed"] == (1 if plan.get("poison_fmt") else 0)
    assert [(t["prefill_tokens"], t["decode"], t["execs"])
            for t in eng.tick_trace] == \
        [(t["prefill_tokens"], t["decode"], t["execs"])
         for t in jeng.tick_trace]


def test_replay_restores_the_pre_tick_state(served):
    """The escalating plan: the replayed tick starts from the kept copy of
    all three state leaves of both layers, which is what the cache held
    before the poisoned attempt."""
    eng = _port(served, dict(poison_logits={3: None}, poison_fmt="mxint4"))
    seen = []
    real = eng._rewind_state

    def rewind():
        seen.append([t.clone() for t in eng._state_copy])
        real()
        for kept, live in zip(eng._state_copy, eng._state_leaves()):
            assert torch.equal(kept, live)

    eng._rewind_state = rewind
    got = eng.generate(_reqs(served, Request), fmt_override="mxint4")
    assert len(seen) == 1 and all(r.done for r in got)
    assert [tuple(t.shape) for t in seen[0]] == [
        (2, 2, 1, 64), (2, 2, 4, 16, 16), (2, 2, 1, 64)]


def test_snapshot_resume_matches_jax(served, tmp_path):
    base = _port(served).generate(_reqs(served, Request),
                                  fmt_override="mxint8")
    eng = _port(served, dict(preempt_at=4))
    reqs = eng.generate(_reqs(served, Request), fmt_override="mxint8",
                        guard=PreemptionGuard(),
                        snapshot_dir=str(tmp_path / "port"))
    jeng = _jax(served, dict(preempt_at=4))
    jreqs = jeng.generate(_reqs(served, JRequest), fmt_override="mxint8",
                          guard=JGuard(), snapshot_dir=str(tmp_path / "jax"))
    assert not all(r.done for r in reqs)
    assert _streams(reqs) == _streams(jreqs)
    arrays, manifest = io.restore(str(tmp_path / "port"))
    jarrays, jmanifest = jio.restore_flat(str(tmp_path / "jax"))
    fp, jfp = manifest["meta"]["fingerprint"], jmanifest["meta"][
        "fingerprint"]
    assert {k: v for k, v in fp.items() if k != "fused"} == \
        {k: v for k, v in jfp.items() if k != "fused"}
    assert not fp["bucket"]
    # the cache leaves in one order, shift_c / shift_t / wkv (f32), equal
    # to the JAX engine's within the logits' rtol 1e-4 / atol 1e-5 (the
    # wkv sums round in another order)
    cache = sorted(k for k in arrays if k[6:].isdigit())
    jcache = sorted(k for k in jarrays if k[6:].isdigit())
    assert len(cache) == len(jcache) == len(STATE)
    for k, jk in zip(cache, jcache):
        np.testing.assert_allclose(np.asarray(arrays[k]),
                                   np.asarray(jarrays[jk]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    fresh = _port(served)
    done = fresh.resume(str(tmp_path / "port"))
    assert all(r.status is RequestStatus.COMPLETED for r in done)
    assert _streams(done) == _streams(base)
    jdone = _jax(served).resume(str(tmp_path / "jax"))
    assert _streams(done) == _streams(jdone)


def _message(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("what", ["paged", "prefill_chunk", "speculative"])
def test_engine_refusals_say_what_the_reference_says(served, what):
    kw = {"paged": dict(kv_layout="paged"),
          "prefill_chunk": dict(prefill_chunk=16),
          "speculative": {}}[what]
    jkw = dict(kw)
    if what == "speculative":
        kw["speculative"] = SpecConfig(draft_fmt="mxint4", k=4)
        jkw["speculative"] = JSpec(draft_fmt="mxint4", k=4)
    got = _message(lambda: _port(served, **kw))
    want = _message(lambda: _jax(served, **jkw))
    assert got == want
    assert "rwkv" in got or "ssm" in got or "recurrent" in got


@pytest.mark.parametrize("entry", ["prefill_chunk", "mixed_step",
                                   "verify_step"])
def test_model_refusals_say_what_the_reference_says(served, entry):
    """At the model level a recurrent mixer refuses to resume mid-prompt:
    chunked prefill, the mixed tick (and the verify, which runs it)."""
    api, params = served[0], served[1]
    tapi = make_model(served[5])
    tparams = tapi.init_params(0, device="cpu")
    toks = np.zeros((1, 8), np.int32)
    if entry == "prefill_chunk":
        batch = {"tokens": toks, "lengths": np.array([8], np.int32)}
        jcall = lambda: api.prefill_chunk(params, batch,
                                          api.init_cache(1, 32), 0)
        tcall = lambda: tapi.prefill_chunk(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            tapi.init_cache(1, 32, device="cpu"), 0)
    else:
        batch = {"tokens": toks, "q_len": np.array([8], np.int32)}
        clen = np.zeros(1, np.int32)
        jcall = lambda: getattr(api, entry)(params, batch,
                                            api.init_cache(1, 32), clen)
        tcall = lambda: getattr(tapi, entry)(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            tapi.init_cache(1, 32, device="cpu"), torch.from_numpy(clen))
    assert _message(tcall) == _message(jcall)
