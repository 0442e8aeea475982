"""MX gradient compression with error feedback against the JAX package's.

``ef_compress_leaf`` (codes, scales, new error), ``ef_decompress_sum``,
``init_error_state`` and ``compressed_bytes`` bit for bit against
``repro/train/compression.py`` on ragged sizes that need the flatten-pad;
the error-feedback bias vanishing over steps, as ``tests/test_compression.py``
has it; ``compressed_pod_allreduce`` at one pod against the reference's
single-device ``shard_map``, and over a two-process gloo group against the
numpy mean of the two pods' dequantized contributions, each computed by JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.formats import get_format as jformat
from repro.core.mx import dequantize as jdequantize
from repro.train import compression as J
from repro_torch.core.formats import get_format
from repro_torch.core.mx import dequantize
from repro_torch.train.compression import (PAD, compressed_bytes,
                                           compressed_pod_allreduce,
                                           ef_compress_leaf,
                                           ef_decompress_sum,
                                           init_error_state)
from _torch_dist import allreduce_worker, run_ranks

SHAPES = [(67, 33), (1000,), (5, 7, 11), (128,), (3, 128)]
FMTS = ["mxint8", "mxint4", "mxfp8"]


def _grad(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ef_compress_leaf_bit_exact(shape, fmt):
    g, err = _grad(shape, 0), 0.01 * _grad(shape, 1)
    jt, jerr = J.ef_compress_leaf(jnp.asarray(g), jnp.asarray(err),
                                  jformat(fmt, 32))
    t, new_err = ef_compress_leaf(torch.from_numpy(g), torch.from_numpy(err),
                                  get_format(fmt, 32))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(jt.codes))
    np.testing.assert_array_equal(t.scale_exp.numpy(),
                                  np.asarray(jt.scale_exp))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
    assert t.codes.shape[-1] % PAD == 0 and new_err.shape == shape


@pytest.mark.parametrize("shape", SHAPES)
def test_ef_decompress_sum_bit_exact(shape):
    fmt = "mxint8"
    n = int(np.prod(shape))
    pods = [ef_compress_leaf(torch.from_numpy(_grad(shape, s)),
                             torch.zeros(shape), get_format(fmt, 32))[0]
            for s in range(3)]
    codes = torch.stack([t.codes for t in pods])
    scales = torch.stack([t.scale_exp for t in pods])
    got = ef_decompress_sum(codes, scales, get_format(fmt, 32), shape, n)
    want = J.ef_decompress_sum(jnp.asarray(codes.numpy()),
                               jnp.asarray(scales.numpy()), jformat(fmt, 32),
                               shape, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_error_state_and_compressed_bytes_equal_jax():
    shapes = {"a": (1000, 100), "b": (999,), "c": {"d": (3, 5, 7)},
              "e": [(128,), (33,)]}
    port = jax.tree_util.tree_map(lambda s: torch.zeros(s), shapes,
                                  is_leaf=lambda x: isinstance(x, tuple))
    jtree = jax.tree_util.tree_map(lambda s: jnp.zeros(s), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    err = init_error_state(port)
    jerr = J.init_error_state(jtree)
    assert err["c"]["d"].dtype == torch.float32
    for a, b in zip(jax.tree_util.tree_leaves(err),
                    jax.tree_util.tree_leaves(jerr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for fmt in FMTS + ["mxint4", "mxint2"]:
        assert compressed_bytes(port, fmt) == J.compressed_bytes(jtree, fmt)
    assert compressed_bytes(port, "mxint8") < 0.27 * 4 * (100000 + 999 + 105
                                                          + 128 + 33)


def test_error_feedback_removes_bias():
    """Accumulated EF-compressed updates converge to accumulated true
    gradients (``tests/test_compression.py``'s case, on the port)."""
    fmt = get_format("mxint4", 32)
    g = torch.from_numpy(_grad((128,), 1) * 0.01)
    err = torch.zeros_like(g)
    acc_ef, acc_noef = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        t, err = ef_compress_leaf(g, err, fmt)
        acc_ef += dequantize(t).reshape(-1)[:128]
        t2, _ = ef_compress_leaf(g, torch.zeros_like(err), fmt)
        acc_noef += dequantize(t2).reshape(-1)[:128]
    true = g * 50
    e_ef = float(torch.linalg.norm(acc_ef - true) / torch.linalg.norm(true))
    e_no = float(torch.linalg.norm(acc_noef - true) / torch.linalg.norm(true))
    assert e_ef < 0.05
    assert e_ef < e_no * 0.5 or e_no < 1e-6


def _grads(seed):
    return {"w": _grad((64, 32), seed), "b": _grad((33,), seed + 10),
            "blocks": [_grad((5, 7, 11), seed + 20)]}


def test_pod_allreduce_at_one_pod_equals_jax_shard_map():
    g = _grads(2)
    fn = J.shard_map(functools.partial(J.compressed_pod_allreduce,
                                       fmt_name="mxint8"),
                     mesh=jax.make_mesh((1,), ("pod",)), in_specs=(P(), P()),
                     out_specs=(P(), P()), check_vma=False)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    jred, jerr = jax.jit(fn)(jg, J.init_error_state(jg))
    tg = jax.tree_util.tree_map(torch.from_numpy, g)
    red, err = compressed_pod_allreduce(tg, init_error_state(tg), "mxint8")
    for got, want in ((red, jred), (err, jerr)):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pod_allreduce_over_two_processes_is_the_mean_of_the_pods():
    fmt = "mxint8"
    by_rank = [{"w": _grad((64, 32), r), "b": _grad((33,), 10 + r)}
               for r in range(2)]
    out = run_ranks(allreduce_worker, 2, by_rank, fmt)
    for k in ("w", "b"):
        deq = []
        for r in range(2):
            g = jnp.asarray(by_rank[r][k])
            t, jerr = J.ef_compress_leaf(g, jnp.zeros_like(g),
                                         jformat(fmt, 32))
            deq.append(np.asarray(jdequantize(t)).reshape(-1)[:g.size]
                       .reshape(g.shape))
            np.testing.assert_array_equal(out[r][1][k], np.asarray(jerr))
        want = (deq[0] + deq[1]) / np.float32(2)
        for r in range(2):
            np.testing.assert_array_equal(out[r][0][k], want)
