"""The roofline terms of the port's cost model (``launch/costmodel.py``,
``configs/shapes.py``) against the JAX package's, exactly.

For every config at reduced and full width, every ``SHAPES`` entry and the
meshes (1, 1, 1), (1, 16, 16) and (2, 16, 16): ``active_params``,
``attn_score_macs``, the ``flops_*``, ``hbm_*`` and ``collectives_*`` terms
and every key of ``roofline`` but its times are equal to the reference's;
the three times are the reference's flops and bytes over the port's H100
constants (``launch/mesh.py``), and ``dominant``, ``roofline_fraction`` and
``step_time_lower_bound`` follow from them. The case list is
``tests/test_costmodel.py``'s.
"""
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import shapes as jshapes
from repro.launch import costmodel as jcm
from repro_torch.configs import get_config, get_reduced, list_archs, shapes
from repro_torch.launch import costmodel as cm
from repro_torch.launch import mesh

MESHES = ((1, 1, 1), (1, 16, 16), (2, 16, 16))


def _pair(arch, width):
    return (get_reduced(arch), jget_reduced(arch)) if width == "reduced" \
        else (get_config(arch), jget_config(arch))


def test_shapes_equal_the_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in shapes.SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in jshapes.SHAPES.items()}
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert shapes.subquadratic(cfg) == jshapes.subquadratic(jcfg)
        for name in shapes.SHAPES:
            s, js = shapes.SHAPES[name], jshapes.SHAPES[name]
            assert shapes.applicable(cfg, s) == jshapes.applicable(jcfg, js)
            assert shapes.decode_cache_len(cfg, s) == \
                jshapes.decode_cache_len(jcfg, js)


@pytest.mark.parametrize("shape", sorted(shapes.SHAPES))
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_terms_equal_the_reference(arch, width, shape):
    cfg, jcfg = _pair(arch, width)
    s, js = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert cm.active_params(cfg) == jcm.active_params(jcfg)
    for sq, skv, b in ((1, s.seq_len, s.global_batch),
                       (s.seq_len, s.seq_len, s.global_batch), (7, 300, 3)):
        assert cm.attn_score_macs(cfg, sq, skv, b) == \
            jcm.attn_score_macs(jcfg, sq, skv, b)
    assert cm.flops_train(cfg, s) == jcm.flops_train(jcfg, js)
    assert cm.flops_prefill(cfg, s) == jcm.flops_prefill(jcfg, js)
    assert cm.flops_decode(cfg, s) == jcm.flops_decode(jcfg, js)
    for dims in MESHES:
        m, jm = cm.MeshDesc(*dims), jcm.MeshDesc(*dims)
        assert (m.chips, m.dp) == (jm.chips, jm.dp)
        assert cm.hbm_train(cfg, s, m) == jcm.hbm_train(jcfg, js, jm)
        assert cm.hbm_prefill(cfg, s, m) == jcm.hbm_prefill(jcfg, js, jm)
        assert cm.collectives_train(cfg, s, m) == \
            jcm.collectives_train(jcfg, js, jm)
        assert cm.collectives_prefill(cfg, s, m) == \
            jcm.collectives_prefill(jcfg, js, jm)
        for bits in (4, 8, 16):
            for ws in (False, True):
                assert cm.hbm_decode(cfg, s, m, bits, ws) == \
                    jcm.hbm_decode(jcfg, js, jm, bits, ws), (dims, bits, ws)
                assert cm.collectives_decode(cfg, s, m, ws, bits) == \
                    jcm.collectives_decode(jcfg, js, jm, ws, bits)
                _roofline_equal(cfg, jcfg, s, js, m, jm, bits, ws)


def _roofline_equal(cfg, jcfg, s, js, m, jm, bits, ws):
    got = cm.roofline(cfg, s, m, bits, ws)
    want = jcm.roofline(jcfg, js, jm, bits, ws)
    own = ("t_compute", "t_memory", "t_collective", "dominant",
           "roofline_fraction", "step_time_lower_bound")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in own} == \
        {k: v for k, v in want.items() if k not in own}
    times = {"compute": want["flops_global"] / jm.chips
             / mesh.PEAK_FLOPS_BF16,
             "memory": want["hbm_bytes_per_dev"] / mesh.HBM_BW,
             "collective": want["coll_bytes_per_dev"] / mesh.LINK_BW}
    assert (got["t_compute"], got["t_memory"], got["t_collective"]) == \
        (times["compute"], times["memory"], times["collective"])
    bound = max(times.values())
    assert got["step_time_lower_bound"] == bound
    assert times[got["dominant"]] == bound
    assert got["roofline_fraction"] == times["compute"] / bound


def test_one_card_bound_of_a_training_step():
    """smollm-135m at seq 512 x 8 on one H100: the training step is bound
    by its flops (``flops_train`` over the bf16 peak); the collective
    terms that are not zero on one card (the reference's ``logits``) stay
    far below it."""
    cfg = get_config("smollm-135m")
    r = cm.roofline(cfg, shapes.ShapeSpec("t", 512, 8, "train"),
                    cm.MeshDesc(1, 1, 1))
    assert r["dominant"] == "compute"
    assert r["step_time_lower_bound"] == \
        cm.flops_train(cfg, shapes.ShapeSpec("t", 512, 8, "train"))[
            "total"] / mesh.PEAK_FLOPS_BF16
    assert r["coll_breakdown"]["all_gather"] == 0.0
    d = cm.roofline(cfg, shapes.ShapeSpec("d", 512, 4, "decode"),
                    cm.MeshDesc(1, 1, 1))
    assert d["coll_breakdown"]["logits"] > 0 and d["dominant"] == "memory"
