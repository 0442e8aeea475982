"""Seeded sampling (``serve/sampling.py`` and the engine's sampled path)
against JAX.

- The key chain (``PRNGKey``, ``split``, ``fold_in``), raw bits and
  ``uniform`` are bit-exact against ``jax.random`` over several seeds and
  shapes; ``gumbel`` is within 1e-6 (it goes through ``log``);
  ``categorical`` and ``sample_batch`` draw the same tokens as
  ``jax.random.categorical`` and the reference engine's ``_sample_batch``.
- The port's sampled ``ElasticEngine`` streams equal the JAX engine's,
  token for token, on a reduced qwen3-4b (a JAX-written anchor), at seeds 0
  and 5, on both KV layouts, monolithic and chunked, under both
  schedulers; the reference's own sampling cases hold, each against the
  JAX engine; and a guard replay or a step retry on a sampled wave
  (reduced smollm-135m, mxint4/6/8) gives the JAX engine's streams and
  events.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.runtime.fault import FaultInjector as JFault
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import _sample_batch
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve import sampling as S
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus

SEEDS = (0, 5, 123456, 2 ** 31 - 1)
SHAPES = ((1,), (7,), (3, 5), (1000,))
TINY = float(np.finfo(np.float32).tiny)
PS = 8


def _np(key):
    return np.asarray(key).astype(np.int64)


# ---------------------------------------------------------------------------
# The key chain and the draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), S.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for num in (2, 3, 4, 9):
        np.testing.assert_array_equal(S.split(tk, num).numpy(),
                                      _np(jax.random.split(jk, num)))
    for data in (0, 1, 7, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(S.fold_in(tk, data).numpy(),
                                      _np(jax.random.fold_in(jk, data)))
    # a batch of keys, as the engine splits and folds them
    jkeys = jax.random.split(jk, 4)
    tkeys = torch.from_numpy(_np(jkeys))
    np.testing.assert_array_equal(
        S.split(tkeys).numpy(), _np(jax.vmap(jax.random.split)(jkeys)))
    np.testing.assert_array_equal(
        S.fold_in(tkeys, 11).numpy(),
        _np(jax.vmap(lambda k: jax.random.fold_in(k, 11))(jkeys)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_are_bit_exact(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), S.prng_key(seed)
    np.testing.assert_array_equal(S.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)))
    for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.5)):
        np.testing.assert_array_equal(
            S.uniform(tk, shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_1e6_and_categorical_picks_the_same(seed):
    jk, tk = jax.random.PRNGKey(seed), S.prng_key(seed)
    np.testing.assert_allclose(S.gumbel(tk, (50_000,)).numpy(),
                               np.asarray(jax.random.gumbel(jk, (50_000,))),
                               rtol=1e-6, atol=1e-6)
    lg = np.random.default_rng(seed % 1000).normal(
        size=(50_000,)).astype(np.float32)
    assert int(S.categorical(tk, torch.from_numpy(lg))) == \
        int(jax.random.categorical(jk, lg))


@pytest.mark.parametrize("temp,top_p", [(1.0, 1.0), (0.8, 0.95), (0.7, 0.5),
                                        (1.3, 0.9), (0.0, 1.0), (1.0, 1e-6)])
def test_sample_batch_draws_the_references_tokens(temp, top_p):
    rng = np.random.default_rng(int(temp * 10 + top_p * 100))
    b, v = 4, 3000
    lg = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    for seed in (3, 5):
        keys = jax.random.split(jax.random.PRNGKey(seed), b)
        temps = np.full(b, temp, np.float32)
        tops = np.full(b, top_p, np.float32)
        temps[1], tops[2] = 1.1, 0.8          # per-slot lanes
        jnext, jtok = _sample_batch(keys, jnp.asarray(lg),
                                    jnp.asarray(temps), jnp.asarray(tops))
        tnext, ttok = S.sample_batch(torch.from_numpy(_np(keys)),
                                     torch.from_numpy(lg),
                                     torch.from_numpy(temps),
                                     torch.from_numpy(tops))
        np.testing.assert_array_equal(tnext.numpy(), _np(jnext))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        k1, t1 = S.sample_one(torch.from_numpy(_np(keys[0])),
                              torch.from_numpy(lg[0]), temps[0], tops[0])
        assert int(t1) == int(jtok[0])
        np.testing.assert_array_equal(k1.numpy(), _np(jnext[0]))


def test_prng_key_refuses_a_seed_past_int32():
    with pytest.raises(ValueError, match="int32"):
        S.prng_key(2 ** 31)


# ---------------------------------------------------------------------------
# The engine's sampled streams against the JAX engine
# ---------------------------------------------------------------------------
SLOTS, MAX_LEN, MAX_NEW = 2, 48, 6
PAGED = dict(kv_layout="paged", kv_page_size=PS)
CONFIGS = {
    "dense-monolithic": {},
    "dense-chunk-mixed": dict(prefill_chunk=8),
    "dense-chunk-sequential": dict(prefill_chunk=8, scheduler="sequential"),
    "paged-monolithic": PAGED,
    "paged-chunk-mixed": dict(PAGED, prefill_chunk=8),
    "paged-chunk-sequential": dict(PAGED, prefill_chunk=8,
                                   scheduler="sequential"),
}


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    api = jget_model(jreduced("qwen3-4b"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


def _prompts(vocab, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 21)))
            .astype(np.int32) for _ in range(n)]


def _both(served, arch, specs, greedy=False, fmt="mxint8", **kw):
    """``specs``: (rid, prompt, max_new, Request kwargs) tuples served by
    the JAX engine and the port's; returns (JAX requests, port requests,
    JAX engine, port engine)."""
    api, params, janchor, anchor = served
    kw.setdefault("batch_slots", SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    jeng = JEngine(api, janchor, fused=False, param_template=params, **kw)
    eng = ElasticEngine(make_model(get_reduced(arch)), anchor, device="cpu",
                        **kw)
    want = [JRequest(rid, p, n, **rk) for rid, p, n, rk in specs]
    got = [Request(rid, p, n, **rk) for rid, p, n, rk in specs]
    jeng.generate(want, greedy=greedy, fmt_override=fmt)
    eng.generate(got, greedy=greedy, fmt_override=fmt)
    return want, got, jeng, eng


def _streams(reqs):
    return [r.out_tokens for r in reqs]


def _specs(prompts, max_new=MAX_NEW, params=None):
    params = params or {}
    return [(i, p, max_new, params.get(i, {})) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sampled_streams_equal_the_jax_engine(qwen, name, seed):
    """Two requests carry their own temperature / top-p; more requests than
    slots, so slots retire, re-admit and reseed."""
    prompts = _prompts(qwen[0].cfg.vocab)
    specs = _specs(prompts, params={1: dict(temperature=1.3),
                                    3: dict(temperature=0.6, top_p=0.7)})
    want, got, jeng, eng = _both(qwen, "qwen3-4b", specs, seed=seed,
                                 temperature=0.8, top_p=0.95,
                                 **CONFIGS[name])
    assert _streams(got) == _streams(want)
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    assert [(t["prefill_tokens"], t["decode"], t["execs"])
            for t in eng.tick_trace] == \
        [(t["prefill_tokens"], t["decode"], t["execs"])
         for t in jeng.tick_trace]
    # the slots' key lanes end where the reference's do
    np.testing.assert_array_equal(eng._keys.numpy(), _np(jeng._slot_keys))


def test_sampling_per_slot_streams_and_determinism(qwen):
    """Identical prompts in two slots draw independent streams; (seed,
    rid) reproduces a stream; the seed matters — each run the JAX
    engine's."""
    prompt = (np.arange(8) % qwen[0].cfg.vocab).astype(np.int32)

    def run(seed):
        want, got, _, _ = _both(qwen, "qwen3-4b",
                                _specs([prompt, prompt.copy()]), seed=seed,
                                temperature=1.0, top_p=0.95)
        assert _streams(got) == _streams(want)
        return _streams(got)

    a, b, c = run(0), run(0), run(5)
    assert a[0] != a[1] and a == b and a != c


def test_per_request_sampling_params_bit_identical_to_solo(qwen):
    prompt = (np.arange(8) % qwen[0].cfg.vocab).astype(np.int32)
    specs = [(0, prompt, 6, dict(temperature=0.7, top_p=0.95)),
             (1, prompt, 6, dict(temperature=1.3)),
             (2, prompt, 6, {})]
    kw = dict(temperature=0.9, top_p=0.85)
    want, got, _, _ = _both(qwen, "qwen3-4b", specs, **kw)
    assert _streams(got) == _streams(want)
    for spec, batched in zip(specs, got):
        _, solo, _, _ = _both(qwen, "qwen3-4b", [spec], **kw)
        assert solo[0].out_tokens == batched.out_tokens, spec[0]


def test_top_p_collapse_equals_greedy(qwen):
    prompts = _prompts(qwen[0].cfg.vocab, n=2, seed=11)
    want, got, _, _ = _both(qwen, "qwen3-4b", _specs(prompts, 5),
                            temperature=1.0, top_p=1e-6)
    _, greedy, _, _ = _both(qwen, "qwen3-4b", _specs(prompts, 5),
                            greedy=True)
    assert _streams(got) == _streams(want) == _streams(greedy)


@pytest.mark.parametrize("kv", [{}, PAGED], ids=["dense", "paged"])
def test_chunked_matches_monolithic_sampled(qwen, kv):
    prompts = _prompts(qwen[0].cfg.vocab, seed=4)
    kw = dict(seed=3, temperature=1.0, top_p=0.9, **kv)
    want, mono, _, _ = _both(qwen, "qwen3-4b", _specs(prompts), **kw)
    _, chunked, _, _ = _both(qwen, "qwen3-4b", _specs(prompts),
                             prefill_chunk=8, **kw)
    assert _streams(mono) == _streams(chunked) == _streams(want)


def test_paged_matches_dense_seeded_sampling(qwen):
    prompts = _prompts(qwen[0].cfg.vocab, n=3, seed=11)
    kw = dict(seed=3, temperature=1.0, top_p=0.9)
    want, dense, _, _ = _both(qwen, "qwen3-4b", _specs(prompts, 5), **kw)
    _, paged, _, _ = _both(qwen, "qwen3-4b", _specs(prompts, 5), **PAGED,
                           **kw)
    assert _streams(dense) == _streams(paged) == _streams(want)


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_unbucketed_prompts_run_at_their_own_length(qwen, chunk):
    """``bucket_prompts=False``: every prefill (or final chunk) runs at the
    prompt's own length, as the JAX engine's; greedy and sampled streams
    equal the bucketed engine's and the JAX engine's."""
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, qwen[0].cfg.vocab, 9 + i).astype(np.int32)
               for i in range(4)]                        # 9..12 -> bucket 16
    kw = dict(PAGED, prefill_chunk=chunk, seed=1, temperature=0.9)
    for greedy in (True, False):
        want, got, jeng, eng = _both(qwen, "qwen3-4b", _specs(prompts, 4),
                                     greedy=greedy, bucket_prompts=False,
                                     **kw)
        _, bucketed, _, beng = _both(qwen, "qwen3-4b", _specs(prompts, 4),
                                     greedy=greedy, **kw)
        assert _streams(got) == _streams(want) == _streams(bucketed)
        widths = [t["prefill_tokens"] for t in eng.tick_trace
                  if t["prefill_tokens"]]
        assert widths == [t["prefill_tokens"] for t in jeng.tick_trace
                          if t["prefill_tokens"]]
        assert eng.stats()["prefills"] == beng.stats()["prefills"]
        if chunk is None:                  # two admissions per tick
            assert sum(widths) == sum(p.size for p in prompts)
            assert all(t["prefill_tokens"] % 16 == 0
                       for t in beng.tick_trace)


# ---------------------------------------------------------------------------
# The guard and the step retry under sampling
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smollm(tmp_path_factory):
    api = jget_model(jreduced("smollm-135m"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    qat = JQAT(formats=("mxint4", "mxint6", "mxint8"), anchor="mxint8",
               block_size=32)
    anchor = jax.jit(lambda p: jmake(p, qat))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


@pytest.mark.parametrize("plan,fmt,kw", [
    (dict(poison_logits={2: None}, poison_fmt="mxint4"), "mxint4", {}),
    (dict(poison_logits={3: 1}), "mxint8", {}),
    (dict(raise_in_step=(1, 3)), "mxint8", {}),
    (dict(poison_logits={4: None}, poison_fmt="mxint4"), "mxint4",
     dict(prefill_chunk=PS)),
], ids=["escalates", "retires-a-row", "step-retry", "mixed-escalates"])
def test_guard_replay_on_a_sampled_wave_equals_the_jax_engine(smollm, plan,
                                                              fmt, kw):
    """A replayed tick draws from the same pre-tick keys, so the streams,
    statuses and events are the JAX engine's."""
    api, params, janchor, anchor = smollm
    kw = dict(kw, batch_slots=2, max_len=32, kv_layout="paged",
              kv_page_size=PS, attn_impl="gather", seed=2, temperature=0.9,
              top_p=0.9)
    jfi, fi = JFault(**plan), FaultInjector(**plan)
    jeng = JEngine(api, janchor, param_template=params, fault_injector=jfi,
                   **kw)
    eng = ElasticEngine(make_model(get_reduced("smollm-135m")), anchor,
                        fault_injector=fi, device="cpu", **kw)
    prompts = [np.random.default_rng(7).integers(0, api.cfg.vocab, 8)
               .astype(np.int32) for _ in range(3)]
    want = [JRequest(i, p, 5) for i, p in enumerate(prompts)]
    got = [Request(i, p, 5) for i, p in enumerate(prompts)]
    jeng.generate(want, greedy=False, fmt_override=fmt)
    eng.generate(got, greedy=False, fmt_override=fmt)
    assert _streams(got) == _streams(want)
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert [r.error for r in got] == [r.error for r in want]
    assert fi.events == jfi.events and fi.events
    st, js = eng.stats(), jeng.stats
    for key in ("escalation_events", "faults_detected", "ticks_replayed",
                "request_statuses", "quarantined_formats"):
        assert st[key] == js[key], key
    assert st["faults_detected"] >= 1
    np.testing.assert_array_equal(eng._keys.numpy(), _np(jeng._slot_keys))
