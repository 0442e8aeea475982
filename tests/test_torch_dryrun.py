"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's (``repro/launch/dryrun.py``) and against real steps.

- ``batch_specs``, the decode cache's rounding and the ``applicable`` skips
  equal the reference's for every arch and shape;
- ``collective_bytes`` of records equivalent to the HLO lines of
  ``tests/test_dryrun_tools.py::test_parse_collective_bytes`` gives
  ``parse_collective_bytes``' dict exactly;
- the trace on fake tensors equals the same counters over the real step on
  the CPU at 1 x 1 (FLOPs, argument / output / alias bytes and the tracked
  peak; the bytes moved within 1e-3), and at (1, 2) its collectives (kind,
  bytes, ranks, in order), FLOPs and memory equal what rank 0 of a real
  gloo group issues;
- the JAX oracle: the reference's ``lower_cell`` of a reduced train cell on
  the session's (1, 2) host mesh (its mesh, config and shapes monkeypatched
  in its namespace) has the port's per-device argument bytes once the batch
  and the three int32 scalars are set aside;
- ``make_production_mesh`` inside ``fake_world`` and outside it; every cell
  leaves ``torch.distributed`` as it found it; the dense configs whose
  dims 16 does not cut are refused by name; ``sp`` / ``sp_mb4`` trace a
  production cell with ``seq_sharding`` and their microbatches;
- each kernel's shape-only branch on fake ``cuda`` and ``meta`` tensors:
  the plain version's shapes and dtypes, one launch recorded and no
  launch counter bumped; a CPU tensor still takes the plain version; a
  ``meta`` trace's launches are its records'.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.dryrun as ref
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.configs.shapes import applicable as japplicable
from repro.configs.shapes import decode_cache_len as jdecode_cache_len
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.kernels import common as kernel_common
from repro_torch.kernels import (fake_quant, mx_matmul, mx_quantize, ops,
                                 paged_attention, ss_convert)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from _torch_dist import dryrun_cells_worker, start_ranks

ARCHS = list_archs()
SEQ, BATCH = 64, 4
GLOO_CELLS = (("qwen3-4b", "train"), ("qwen3-4b", "decode"),
              ("mixtral-8x7b", "train"))
_JDTYPE = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32}


def _shape(kind):
    return ShapeSpec(kind, SEQ, BATCH, kind)


# ---- shapes and skips -------------------------------------------------------
def test_archs_match_reference():
    from repro.configs import list_archs as jlist
    assert ARCHS == jlist()
    assert list(SHAPES) == list(JSHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        for kind in ("train", "prefill", "decode"):
            got = dryrun.batch_specs(cfg, SHAPES[name], kind)
            want = ref.batch_specs(jcfg, JSHAPES[name], kind)
            assert list(got) == list(want), (name, kind)
            for k, (shape, dtype) in got.items():
                assert shape == tuple(want[k].shape), (name, kind, k)
                assert dtype == _JDTYPE[jnp.dtype(want[k].dtype)], (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_alloc_and_skips_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        assert applicable(cfg, SHAPES[name]) == japplicable(
            jcfg, JSHAPES[name]), name
        want = -(-(jdecode_cache_len(jcfg, JSHAPES[name]) + 1) // 128) * 128
        assert dryrun.decode_alloc(cfg, SHAPES[name]) == want, name
        if not applicable(cfg, SHAPES[name]):
            assert dryrun.lower_cell(arch, name, False) == {
                "status": "skipped",
                "reason": "full-attention arch at 500k"}


def test_collective_bytes_match_parse():
    hlo = """
  %ag = f32[16,512]{1,0} all-gather(%x), replica_groups=...
  %ar = bf16[8,128]{1,0} all-reduce(%y), to_apply=%add
  %rs = f32[4,64]{1,0} reduce-scatter(%z), dimensions={0}
  %a2a = s8[32]{0} all-to-all(%w)
  %cp = f32[2,2]{1,0} collective-permute(%v)
  %ags = (f32[16,512]{1,0}, u32[]) all-gather-start(%x2)
  %not = f32[9,9]{1,0} add(%a, %b)
"""
    records = [{"kind": "all-gather", "bytes": 16 * 512 * 4},
               {"kind": "all-reduce", "bytes": 8 * 128 * 2},
               {"kind": "reduce-scatter", "bytes": 4 * 64 * 4},
               {"kind": "all-to-all", "bytes": 32},
               {"kind": "collective-permute", "bytes": 2 * 2 * 4},
               {"kind": "all-gather", "bytes": 16 * 512 * 4}]
    assert dryrun.collective_bytes(records) == ref.parse_collective_bytes(hlo)


def test_record_collectives_restores_functions():
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                           "reduce_scatter_tensor",
                                           "all_to_all")}
    with dryrun.fake_world(2):
        with dryrun.record_collectives() as recs:
            t = torch.zeros(3, 4)
            dist.all_reduce(t)
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
    assert recs == [{"kind": "all-reduce", "bytes": 48, "ranks": 2},
                    {"kind": "all-gather", "bytes": 96, "ranks": 2}]
    assert {n: getattr(dist, n) for n in saved} == saved
    assert not dist.is_initialized()


def test_memory_tracker_counts_each_storage_once():
    a = torch.zeros(4, 4)
    with dryrun.MemoryTracker([a]) as mem:
        b = a + 1                     # 64 bytes
        v = b[1:]                     # a view: nothing new
        c = v * 2                     # 48 bytes: peak 112
        del b, v, c                   # all freed
        d = a.clone()                 # 64 bytes
    assert mem.peak_bytes == 112
    assert mem.live_bytes == 64
    assert mem.bytes_accessed == 64 * 2 + 48 * 2 + 64 * 2
    del d


# ---- the trace against real steps ------------------------------------------
@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "train"),
                                       ("qwen3-4b", "prefill"),
                                       ("qwen3-4b", "decode"),
                                       ("mixtral-8x7b", "train")])
def test_fake_trace_equals_real_cpu_step(arch, kind):
    mesh = make_debug_mesh(1, 1)
    cfg = get_reduced(arch)
    fake = dryrun.trace_cell(cfg, _shape(kind), mesh, device="cpu")
    real = dryrun.trace_cell(cfg, _shape(kind), mesh, device="cpu",
                             fake=False)
    assert fake["flops"] > 0 and fake["memory"]["temp_size_in_bytes"] > 0
    for key in ("flops", "flops_counted", "memory", "launches",
                "setup_launches"):
        assert fake[key] == real[key], key
    # one_hot (MoE routing) checks its classes against the data on the
    # CPU (aminmax, scatter_) and compares with an arange on fake tensors
    assert fake["bytes_accessed"] == pytest.approx(real["bytes_accessed"],
                                                   rel=1e-3)
    assert fake["collective_records"] == real["collective_records"] == []
    assert fake["trace_device"] == "cpu"


def test_collectives_equal_a_gloo_step():
    cells = [(arch, kind, SEQ, BATCH) for arch, kind in GLOO_CELLS]
    wait = start_ranks(dryrun_cells_worker, 2, cells)
    fakes = []
    with dryrun.fake_world(2):
        mesh = make_debug_mesh(1, 2)
        for arch, kind in GLOO_CELLS:
            fakes.append(dryrun.trace_cell(get_reduced(arch), _shape(kind),
                                           mesh, device="cpu"))
    assert not dist.is_initialized()
    real = wait()[0]
    for (arch, kind), f, r in zip(GLOO_CELLS, fakes, real):
        assert f["collective_records"] == r["collective_records"], (arch, kind)
        assert f["collective_records"], (arch, kind)
        assert f["flops"] == r["flops"], (arch, kind)
        assert f["memory"] == r["memory"], (arch, kind)


def test_argument_bytes_equal_jax_lower_cell(monkeypatch):
    """The reference's compiled train cell on the (1, 2) host mesh against
    the port's trace of rank 0: per device, the state is the same bytes;
    JAX's arguments add the batch (int32 tokens and labels, whole on a
    data axis of 1) and three int32 scalars (the step, AdamW's step and the
    format index), the port's the same batch (its step and format index
    are host ints)."""
    from jax.sharding import AxisType
    monkeypatch.setattr(ref, "make_production_mesh", lambda multi_pod=False:
                        jax.make_mesh((1, 2), ("data", "model"),
                                      axis_types=(AxisType.Auto,) * 2))
    monkeypatch.setattr(ref, "get_config", jget_reduced)
    monkeypatch.setattr(ref, "SHAPES", {
        "train_4k": JShapeSpec("train_4k", SEQ, BATCH, "train")})
    want = ref.lower_cell("qwen3-4b", "train_4k", False)
    assert want["status"] == "ok", want
    with dryrun.fake_world(2):
        got = dryrun.trace_cell(get_reduced("qwen3-4b"), _shape("train"),
                                make_debug_mesh(1, 2), device="cpu")
    batch = sum(math.prod(s) * torch.empty((), dtype=dt).element_size()
                for s, dt in dryrun.batch_specs(
                    get_reduced("qwen3-4b"), _shape("train"),
                    "train").values())
    assert batch == 2 * BATCH * SEQ * 4
    assert want["memory"]["argument_size_in_bytes"] - 3 * 4 == \
        got["memory"]["argument_size_in_bytes"]


# ---- the world, the mesh, refusals ------------------------------------------
@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_make_production_mesh(multi_pod, shape, names):
    n = int(np.prod(shape))
    with pytest.raises(ValueError, match=r"Number of devices 1 must be >="):
        make_production_mesh(multi_pod=multi_pod)
    with dryrun.fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.devices.shape == shape and mesh.axis_names == names
        assert mesh.coords == {a: 0 for a in names}
        assert dist.get_world_size(mesh.group_of(("model",))) == 16
        assert dist.get_world_size(mesh.group_of(("pod", "data"))) == n // 16
        with dryrun.fake_world(8):          # an existing group is kept
            assert dist.get_world_size() == n
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,dim", [("qwen2-72b", "d_ff"),
                                      ("smollm-135m", "n_heads"),
                                      ("starcoder2-3b", "n_heads")])
def test_dense_configs_refused_at_16(arch, dim):
    for multi_pod in (False, True):
        rec = dryrun.lower_cell(arch, "decode_32k", multi_pod)
        assert not dist.is_initialized()
        assert rec["status"] == "refused", rec
        assert rec["mesh"] == ("pod2x16x16" if multi_pod else "16x16")
        assert f"'{dim}'" in rec["reason"] and "size 16" in rec["reason"]


def test_sp_variants_trace_with_the_flag_and_microbatch(monkeypatch):
    """``lower_cell`` at ``sp`` / ``sp_mb4`` on the 16 x 16 fake world:
    ``ok``, the step built with ``seq_sharding`` and 1 / 4 microbatches
    (qwen3-4b at its published widths, cut to 2 layers to keep the trace
    short)."""
    built = []
    real = dryrun.make_sharded_train_step

    def recording(api, mesh, opt, shapes, microbatch=1):
        built.append((api.cfg.seq_sharding, microbatch))
        return real(api, mesh, opt, shapes, microbatch=microbatch)

    monkeypatch.setattr(dryrun, "make_sharded_train_step", recording)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses
                        .replace(get_config(arch), n_layers=2))
    for variant, mb in (("sp", 1), ("sp_mb4", 4)):
        rec = dryrun.lower_cell("qwen3-4b", "train_4k", False,
                                variant=variant)
        assert not dist.is_initialized()
        assert rec["status"] == "ok", rec
        assert rec["variant"] == variant
        assert built.pop() == (True, mb)
        assert rec["collectives"]["all-gather"] > 0
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.variant_setup(get_config("qwen3-4b"), "w2", None)


def test_variant_mapping():
    cfg = get_config("qwen3-4b")
    got = {v: dryrun.variant_setup(cfg, v, None) for v in dryrun.VARIANTS}
    assert got["novjp"][0].flash_vjp is False
    assert {v for v in got if got[v][0].seq_sharding} == {"sp", "sp_mb4"}
    assert [got[v][1] for v in ("baseline", "sp", "sp_mb4")] == [1, 1, 4]
    assert got["sp"][2:] == got["sp_mb4"][2:] == (None, None, None)
    assert [got[v][1] for v in ("inner", "inner_mb4", "inner_mb8")] == \
        [1, 4, 8]
    assert all(got[v][0].remat_inner for v in ("inner", "inner_mb8"))
    assert {v: got[v][2] for v in ("w16tp", "w8tp", "w4tp", "w8", "w4",
                                   "w8scan", "w4scan", "baseline")} == {
        "w16tp": None, "w8tp": 8, "w4tp": 4, "w8": 8, "w4": 4,
        "w8scan": 8, "w4scan": 4, "baseline": None}
    assert {v for v in got if got[v][3] == {"fsdp": ()}} == {
        "w16tp", "w8tp", "w4tp", "w8scan", "w4scan"}
    assert "w4tp step" in got["w4scan"][4]


def test_main_writes_and_resumes(tmp_path, capsys):
    args = ["--arch", "qwen2-72b", "--shape", "train_4k", "--mesh", "both",
            "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["qwen2-72b__train_4k__16x16__baseline.json",
                     "qwen2-72b__train_4k__pod2x16x16__baseline.json"]
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.count("skip (exists)") == 2
    assert not dist.is_initialized()


def test_main_records_a_trace_over_its_limit(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "TRACE_LIMIT_S", 0.05)
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "qwen3-4b__train_4k__16x16__baseline.json") as f:
        rec = json.load(f)
    assert rec["status"] == "error", rec
    assert rec["error"] == "TimeoutError: the trace took over 0.05 s"
    assert not dist.is_initialized()


# ---- shape-only launches ----------------------------------------------------
F8, F4 = get_format("mxint8", 32), get_format("mxint4", 32)


def _z(shape, dtype, dev):
    return torch.zeros(shape, dtype=dtype, device=dev)


def _mx(dev):
    return MXTensor(codes=_z((64, 96), torch.int8, dev),
                    scale_exp=_z((96, 2), torch.int8, dev), fmt=F8,
                    block_axis=0)


KERNELS = {
    "mx_matmul": lambda d: mx_matmul.mx_matmul(
        _z((4, 64), torch.bfloat16, d), _z((64, 96), torch.int8, d),
        _z((96, 2), torch.int8, d), F8),
    "mx_matmul_int4": lambda d: mx_matmul.mx_matmul_int4(
        _z((4, 64), torch.bfloat16, d), _z((64, 48), torch.uint8, d),
        _z((96, 2), torch.int8, d), F4),
    "paged_attention": lambda d: paged_attention.paged_attention(
        _z((2, 4, 16), torch.bfloat16, d),
        _z((9, 16, 2, 16), torch.bfloat16, d),
        _z((9, 16, 2, 16), torch.bfloat16, d), _z((2, 4), torch.int32, d),
        _z((2,), torch.int32, d)),
    "paged_attention_mq": lambda d: paged_attention.paged_attention_mq(
        _z((2, 3, 4, 16), torch.bfloat16, d),
        _z((9, 16, 2, 16), torch.bfloat16, d),
        _z((9, 16, 2, 16), torch.bfloat16, d), _z((2, 4), torch.int32, d),
        _z((2,), torch.int32, d), _z((2,), torch.int32, d)),
    "ss_convert": lambda d: ops.ss_convert(_mx(d), F4),
    "ss_convert_int4_splitn": lambda d: ops.ss_convert_int4_splitn(_mx(d),
                                                                   F4),
    "mx_quantize": lambda d: ops.mx_quantize(_z((64, 96), torch.float32, d),
                                             F8, 0),
    "fake_quant": lambda d: ops.fake_quant(
        _z((64, 96), torch.float32, d), F4, 0, out_dtype=torch.bfloat16,
        ste=True),
}
_MODULE = {"mx_matmul": mx_matmul, "mx_matmul_int4": mx_matmul,
           "paged_attention": paged_attention,
           "paged_attention_mq": paged_attention, "ss_convert": ss_convert,
           "ss_convert_int4_splitn": ss_convert, "mx_quantize": mx_quantize,
           "fake_quant": fake_quant}


@pytest.mark.parametrize("kind,variant,setup,step", [
    ("train", "baseline", set(), {"fake_quant"}),
    ("decode", "w4", {"mx_quantize", "ss_convert"}, {"mx_matmul_int4"})])
def test_meta_trace_launches_are_its_records(kind, variant, setup, step):
    before = dryrun._launch_counts()
    rec = dryrun.trace_cell(get_reduced("qwen3-4b"), _shape(kind),
                            make_debug_mesh(1, 1), variant, device="meta")
    assert dryrun._launch_counts() == before
    assert rec["launches"] == {k: v["launches"]
                               for k, v in rec["kernels"].items()}
    assert rec["setup_launches"] == {k: v["launches"]
                                     for k, v in rec["setup_kernels"].items()}
    assert (set(rec["setup_launches"]), set(rec["launches"])) == (setup, step)


def _outputs(out):
    if isinstance(out, MXTensor):
        return [out.codes, out.scale_exp]
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("where", ["fake cuda", "meta"])
@pytest.mark.parametrize("case", sorted(KERNELS))
def test_shape_only_launch(case, where):
    from torch._subclasses.fake_tensor import FakeTensorMode
    name = "ss_convert" if case.startswith("ss_convert") else case
    counts = _MODULE[case].launches
    want = _outputs(KERNELS[case]("cpu"))          # the plain version
    before = dict(counts)
    with kernel_common.shape_only_launches() as recs:
        assert not recs and before == counts       # the CPU launches none
        if where == "meta":
            got = _outputs(KERNELS[case]("meta"))
        else:
            with FakeTensorMode():
                got = _outputs(KERNELS[case]("cuda"))
                assert all(kernel_common.shape_only(t) and t.is_cuda
                           for t in got)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert counts == before            # the counters count kernels that ran
    assert [r["name"] for r in recs] == [name]
    assert recs[0]["bytes_read"] > 0 and recs[0]["bytes_written"] > 0
    assert (recs[0]["flops"] > 0) == (name != "ss_convert")
