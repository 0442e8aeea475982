"""The port's preemption, snapshot and resume against the JAX engine's.

The setting is the reference's chaos suite (``tests/test_chaos.py``): a
reduced smollm-135m, an MXINT8 anchor trained for mxint4/6/8 at block size
32 (written by the JAX package, loaded by the port), two slots, max_len 32,
the paged layout with pages of 8 tokens. A ``FaultInjector(preempt_at=t)``
triggers a ``PreemptionGuard`` mid-tick; the engine snapshots at the next
tick boundary and returns the wave incomplete, and ``resume`` on a fresh
engine must finish it with the streams of the uninterrupted wave — which
are the JAX engine's — with the pages balanced across both engines. The
snapshot's host state (queues, cursors, lengths, free list, counters) and
its lengths, tokens, keys and block table must be the JAX engine's
snapshot's at the same tick. Greedy, sampled (seed 0) and speculative
waves, monolithic and mid-prefill under the mixed scheduler, dense and
paged; a bf16 cache round-trips bit for bit; a fingerprint mismatch raises
and names the field.
"""
import jax
import numpy as np
import pytest

from repro.checkpoint import io as jio
from repro.checkpoint.anchor_ckpt import save_anchor as jsave
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
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector, PreemptionGuard
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.policy import SpecConfig

PS = 8
HOST_STATE = ("pending", "active", "slot_len", "filling", "fill_slot",
              "fill_cursor", "wait_pages", "free_pages", "quarantined",
              "pinned", "tick_no", "greedy", "fmt_override", "fingerprint")
COUNTERS = ("ticks", "tokens_out", "kv_pages_alloc", "kv_pages_freed",
            "kv_pages_hwm", "faults_detected", "fmt_escalations",
            "ticks_replayed", "admission_requeues", "attn_tokens_read",
            "spec_ticks", "spec_accepted", "spec_rejected", "spec_aborts",
            "status_counts", "failures", "escalation_events")
WAVES = {
    "greedy": dict(kw={}, tick=2),
    "dense": dict(kw=dict(kv_layout="dense"), tick=2),
    "mixed-mid-prefill-sampled": dict(
        kw=dict(prefill_chunk=PS, seed=0, temperature=0.8, top_p=0.95),
        tick=1, greedy=False, plen=(20, 13, 9)),
    "speculative": dict(kw=dict(spec=dict(draft_fmt="mxint4", k=4)),
                        tick=1, max_new=9),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("smollm-135m"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    qat = JQAT(formats=("mxint4", "mxint6", "mxint8"), anchor="mxint8",
               block_size=32)
    anchor = jax.jit(lambda p: jmake(p, qat))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv_layout", "paged")
    if kw["kv_layout"] == "paged":
        kw.setdefault("kv_page_size", PS)
        kw.setdefault("attn_impl", "gather")    # the JAX engine's on a CPU
    kw.setdefault("fused", False)               # likewise
    return kw


def _port(served, spec=None, preempt_at=None, **kw):
    return ElasticEngine(
        make_model(get_reduced("smollm-135m")), served[3], device="cpu",
        speculative=None if spec is None else SpecConfig(**spec),
        fault_injector=None if preempt_at is None
        else FaultInjector(preempt_at=preempt_at), **_kw(kw))


def _jax(served, spec=None, preempt_at=None, **kw):
    api, params, anchor, _ = served
    return JEngine(api, anchor, param_template=params,
                   speculative=None if spec is None else JSpec(**spec),
                   fault_injector=None if preempt_at is None
                   else JFault(preempt_at=preempt_at), **_kw(kw))


def _prompts(vocab, lens=(8, 8, 8), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _wave(served, name):
    w = WAVES[name]
    return (w["kw"], w["tick"], w.get("greedy", True), w.get("max_new", 6),
            _prompts(served[0].cfg.vocab, w.get("plen", (8, 8, 8))))


def _streams(reqs):
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("name", list(WAVES))
def test_preempt_then_resume_on_a_fresh_engine(served, name, tmp_path):
    kw, tick, greedy, max_new, prompts = _wave(served, name)
    # the uninterrupted wave, on both engines
    base = _port(served, **kw).generate(
        [Request(i, p, max_new) for i, p in enumerate(prompts)],
        greedy=greedy, fmt_override="mxint8")
    jbase = _jax(served, **kw).generate(
        [JRequest(i, p, max_new) for i, p in enumerate(prompts)],
        greedy=greedy, fmt_override="mxint8")
    assert _streams(base) == _streams(jbase)
    # preempted at the same tick on both
    eng = _port(served, preempt_at=tick, **kw)
    guard = PreemptionGuard()
    reqs = eng.generate([Request(i, p, max_new)
                         for i, p in enumerate(prompts)], greedy=greedy,
                        fmt_override="mxint8", guard=guard,
                        snapshot_dir=str(tmp_path / "port"))
    jeng = _jax(served, preempt_at=tick, **kw)
    jreqs = jeng.generate([JRequest(i, p, max_new)
                           for i, p in enumerate(prompts)], greedy=greedy,
                          fmt_override="mxint8", guard=JGuard(),
                          snapshot_dir=str(tmp_path / "jax"))
    assert guard.preempted and not all(r.done for r in reqs)
    assert eng.stats()["snapshots_saved"] == 1
    assert eng._fault_injector.events == jeng._fault_injector.events
    assert _streams(reqs) == _streams(jreqs)
    _same_snapshot(str(tmp_path / "port"), str(tmp_path / "jax"))

    fresh = _port(served, **kw)                 # no injector, nothing shared
    done = fresh.resume(str(tmp_path / "port"))
    assert all(r.status is RequestStatus.COMPLETED for r in done)
    assert _streams(done) == _streams(base)
    st = fresh.stats()
    assert st["resumes"] == 1 and st["snapshots_saved"] == 0
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]   # across both
    assert st["tokens_out"] == base[0].max_new * len(base)
    if kw.get("spec"):
        assert st["spec_ticks"] > eng.stats()["spec_ticks"] > 0
    jdone = _jax(served, **kw).resume(str(tmp_path / "jax"))
    assert _streams(done) == _streams(jdone)


def _same_snapshot(port_dir, jax_dir):
    """The port's snapshot and the JAX engine's, taken at the same tick:
    the same host state and counters, lengths, tokens, keys, sampling
    lanes and block table."""
    arrays, manifest = io.restore(port_dir)
    jarrays, jmanifest = jio.restore_flat(jax_dir)
    meta, jmeta = manifest["meta"], jmanifest["meta"]
    for key in HOST_STATE:
        assert meta[key] == jmeta[key], key
    for key in COUNTERS:
        assert meta["counters"][key] == jmeta["counters"][key], key
    for key in ("cache_len", "tokens", "slot_keys", "engine_key",
                "slot_temp", "slot_topp", "bt"):
        if key in jarrays:
            np.testing.assert_array_equal(
                np.asarray(arrays[key]).astype(np.int64)
                if jarrays[key].dtype.kind in "iu" else arrays[key],
                np.asarray(jarrays[key]).astype(np.int64)
                if jarrays[key].dtype.kind in "iu" else jarrays[key],
                err_msg=key)
    assert [(r["rid"], r["status"], r["fmt_used"])
            for r in meta["requests"]] == \
        [(r["rid"], r["status"], r["fmt_used"]) for r in jmeta["requests"]]


def test_resume_on_the_engine_that_was_preempted(served, tmp_path):
    """The same engine resumes its own snapshot, and a wave after it
    starts from zeroed buffers again."""
    prompts = _prompts(served[0].cfg.vocab)
    base = _streams(_port(served).generate(
        [Request(i, p, 6) for i, p in enumerate(prompts)],
        fmt_override="mxint8"))
    eng = _port(served, preempt_at=3)
    eng.generate([Request(i, p, 6) for i, p in enumerate(prompts)],
                 fmt_override="mxint8", guard=PreemptionGuard(),
                 snapshot_dir=str(tmp_path))
    assert _streams(eng.resume(str(tmp_path))) == base
    eng._fault_injector = None
    assert _streams(eng.generate([Request(i, p, 6)
                                  for i, p in enumerate(prompts)],
                                 fmt_override="mxint8")) == base
    st = eng.stats()
    assert st["resumes"] == 1 and st["kv_pages_alloc"] == st["kv_pages_freed"]


def test_a_resumed_wave_preempted_again(served, tmp_path):
    """Preempted, resumed on a fresh engine and preempted again (its
    snapshot replaces the first in the same directory), then resumed on a
    third: the streams of the uninterrupted wave."""
    prompts = _prompts(served[0].cfg.vocab, lens=(8, 8, 8, 8))
    base = _streams(_port(served).generate(
        [Request(i, p, 6) for i, p in enumerate(prompts)],
        fmt_override="mxint8"))
    _port(served, preempt_at=1).generate(
        [Request(i, p, 6) for i, p in enumerate(prompts)],
        fmt_override="mxint8", guard=PreemptionGuard(),
        snapshot_dir=str(tmp_path))
    guard = PreemptionGuard()
    mid = _port(served, preempt_at=4).resume(str(tmp_path), guard=guard)
    assert guard.preempted and not all(r.done for r in mid)
    third = _port(served)
    done = third.resume(str(tmp_path))
    assert _streams(done) == base
    st = third.stats()
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]


def test_fingerprint_mismatch_raises_and_names_the_field(served, tmp_path):
    eng = _port(served, preempt_at=1)
    eng.generate([Request(i, p, 5) for i, p in enumerate(
        _prompts(served[0].cfg.vocab, lens=(8, 8)))],
        fmt_override="mxint8", guard=PreemptionGuard(),
        snapshot_dir=str(tmp_path))
    for kw, field in ((dict(max_len=64), "max_len"),
                      (dict(spec=dict(draft_fmt="mxint4", k=2)),
                       "speculative"),
                      (dict(attn_impl="paged_kernel"), "attn_impl")):
        with pytest.raises(ValueError, match="fingerprint mismatch") as ei:
            _port(served, **kw).resume(str(tmp_path))
        assert f"'{field}'" in str(ei.value)
    fp = eng._snapshot_fingerprint()
    jfp = _jax(served)._snapshot_fingerprint()
    assert fp == jfp
    assert set(fp) == set(jfp)


def test_a_bf16_cache_round_trips_through_the_snapshot(served, tmp_path):
    """The served configurations keep their KV cache in bf16, which numpy
    stores as 2-byte raw records: each leaf comes back bit for bit into a
    fresh engine's buffers, and the resumed wave equals the uninterrupted
    one."""
    import dataclasses

    import torch
    cfg = dataclasses.replace(get_reduced("smollm-135m"),
                              compute_dtype=torch.bfloat16)

    def engine(**kw):
        return ElasticEngine(make_model(cfg), served[3], device="cpu",
                             **_kw(kw))

    prompts = _prompts(cfg.vocab)
    base = _streams(engine().generate(
        [Request(i, p, 6) for i, p in enumerate(prompts)],
        fmt_override="mxint4"))
    eng = engine(fault_injector=FaultInjector(preempt_at=2))
    eng.generate([Request(i, p, 6) for i, p in enumerate(prompts)],
                 fmt_override="mxint4", guard=PreemptionGuard(),
                 snapshot_dir=str(tmp_path))
    leaves = [t.clone() for t in eng._cache_leaves()]
    assert leaves[0].dtype == torch.bfloat16 and leaves[0].abs().sum() > 0
    fresh = engine()
    fresh.generate = lambda *a, **kw: None      # restore only, then look
    fresh.resume(str(tmp_path))
    for got, want in zip(fresh._cache_leaves(), leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert _streams(engine().resume(str(tmp_path))) == base
