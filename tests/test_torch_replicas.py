"""Data-parallel replicas: the port's ``ReplicaSet`` against the JAX one.

As ``tests/test_mesh_serving.py``'s replica case: the JAX package writes an
MXINT8 anchor of a reduced smollm-135m (projections sharpened x 8, so the
streams are more than the last prompt token repeated); JAX's
``ReplicaSet(n_replicas=2)`` (engines at ``fused=False``) and the port's
serve the same requests. Streams, each request's home replica, and the
set's ``tokens_out`` and ``ticks`` must be equal, and each stream must be
the one a lone engine gives; the refusals carry the reference's messages.
``ReplicaSet(2, tp=2)`` runs in four gloo processes (``tests/
_torch_dist.py``), each replica sharded over two of them: every process
returns every request with JAX's ``tp = 1`` streams (JAX's ``tp > 1``
needs four devices; the host has two) and the set's summed stats.
"""
import jax
import numpy as np
import pytest

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.engine import Request as JRequest
from repro.serve.replicas import ReplicaSet as JReplicaSet
from repro.serve.replicas import replica_meshes as jreplica_meshes
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ElasticEngine, Request
from repro_torch.serve.replicas import ReplicaSet, replica_meshes
from repro_torch.sharding.rules import mesh_sizes
from _torch_dist import replica_set_worker, run_ranks

SLOTS, MAX_LEN, MAX_NEW, N_REQ = 2, 48, 6, 5
PROJ = ("'wq'", "'wk'", "'wv'", "'wo'", "'w_gate'", "'w_up'", "'w_down'")


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 21)))
            .astype(np.int32) for _ in range(N_REQ)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("smollm-135m"))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 8.0 if any(n in jax.tree_util.keystr(p)
                                    for n in PROJ) else x,
        jax.jit(api.init_params)(jax.random.PRNGKey(0)))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    prompts = _prompts(api.cfg.vocab)
    jrs = JReplicaSet(api, anchor, n_replicas=2, batch_slots=SLOTS,
                      max_len=MAX_LEN, param_template=params, fused=False)
    got = jrs.generate([JRequest(i, p, MAX_NEW)
                        for i, p in enumerate(prompts)],
                       greedy=True, fmt_override="mxint8")
    st = jrs.stats
    return (api, params, anchor, path, prompts,
            {"streams": {r.rid: r.out_tokens for r in got},
             "homes": [jrs.home(r.rid) for r in got],
             "tokens_out": st["tokens_out"], "ticks": st["ticks"]})


def _kw():
    return dict(batch_slots=SLOTS, max_len=MAX_LEN, device="cpu")


def test_replica_set_equals_jax_and_a_lone_engine(served):
    _, _, _, path, prompts, want = served
    api, anchor = make_model(get_reduced("smollm-135m")), load_anchor(
        path, device="cpu")
    rs = ReplicaSet(api, anchor, n_replicas=2, **_kw())
    got = rs.generate([Request(i, p, MAX_NEW) for i, p in enumerate(prompts)],
                      greedy=True, fmt_override="mxint8")
    assert {r.rid: r.out_tokens for r in got} == want["streams"]
    assert [rs.home(r.rid) for r in got] == want["homes"] == [0, 1, 0, 1, 0]
    st = rs.stats()
    assert (st["tokens_out"], st["ticks"]) == (want["tokens_out"],
                                               want["ticks"])
    assert st["n_replicas"] == 2 and st["tp"] == 1
    assert [s["tokens_out"] for s in st["replicas"]] == [3 * MAX_NEW,
                                                         2 * MAX_NEW]
    assert [[r.rid for r in part] for part in rs.partition(got)] \
        == [[0, 2, 4], [1, 3]]
    lone = ElasticEngine(api, anchor, **_kw()).generate(
        [Request(i, p, MAX_NEW) for i, p in enumerate(prompts)],
        fmt_override="mxint8")
    assert {r.rid: r.out_tokens for r in lone} == want["streams"]
    assert len({t for s in want["streams"].values() for t in s}) > N_REQ


def _same_error(jcall, call):
    with pytest.raises(ValueError) as je:
        jcall()
    with pytest.raises(ValueError) as pe:
        call()
    assert str(pe.value) == str(je.value)


def test_refusals_match_the_reference(served):
    api, params, anchor, path, _, _ = served
    papi, panchor = make_model(get_reduced("smollm-135m")), load_anchor(
        path, device="cpu")
    jkw = dict(batch_slots=SLOTS, max_len=MAX_LEN, param_template=params,
               fused=False)
    _same_error(lambda: JReplicaSet(api, anchor, n_replicas=0, **jkw),
                lambda: ReplicaSet(papi, panchor, n_replicas=0, **_kw()))
    _same_error(lambda: JReplicaSet(api, anchor, n_replicas=2, mesh=None,
                                    **jkw),
                lambda: ReplicaSet(papi, panchor, n_replicas=2, mesh=None,
                                   **_kw()))
    _same_error(lambda: jreplica_meshes(2, 2),
                lambda: replica_meshes(2, 2, devices=[0, 1]))
    # a sharded replica runs one process per shard: four of them here,
    # joined in a default group, which this process is not
    with pytest.raises(ValueError, match="one per shard"):
        ReplicaSet(papi, panchor, n_replicas=2, tp=2, devices=[0, 1, 2, 3],
                   **_kw())


def test_sharded_replicas_over_four_processes(served):
    """``ReplicaSet(2, tp=2)``: each process holds one shard of one
    replica, serves its replica's part at the same time as the other
    replica, and returns every request, in order, mutated in place."""
    _, _, _, path, prompts, want = served
    ranks = run_ranks(replica_set_worker, 4, "smollm-135m", path, prompts,
                      MAX_NEW, "mxint8", 2, 2)
    for rank, got in enumerate(ranks):
        assert got["replica"] == rank // 2
        assert got["same_objects"] and got["rids"] == list(range(N_REQ))
        assert dict(zip(got["rids"], got["streams"])) == want["streams"]
        assert got["homes"] == want["homes"] == [0, 1, 0, 1, 0]
        assert got["status"] == ["completed"] * N_REQ
        assert got["stats"] == {"n_replicas": 2, "tp": 2,
                                "tokens_out": want["tokens_out"],
                                "ticks": want["ticks"]}
        assert [t for t, _ in got["per_replica"]] == [3 * MAX_NEW,
                                                      2 * MAX_NEW]


def test_replica_meshes_are_disjoint():
    meshes = replica_meshes(3, 2, devices=list(range(6)))
    assert [m.devices.tolist() for m in meshes] == [[[0, 1]], [[2, 3]],
                                                    [[4, 5]]]
    assert all(m.axis_names == ("data", "model") for m in meshes)
    jm = jreplica_meshes(2, 1)
    assert [m.devices.shape for m in replica_meshes(2, 1, [0, 1])] \
        == [m.devices.shape for m in jm]
    assert [mesh_sizes(m) for m in replica_meshes(1)] \
        == [{"data": 1, "model": 1}]
