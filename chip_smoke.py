#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--layers N] [--seed S]

Phases (any failure exits non-zero before the result line):
  1. the card: name, power limit, device count; TF32 off for matmuls and
     cuDNN;
  2. build the two MX dequant-GEMM kernels (src/repro_torch/csrc/) with nvcc
     for sm_90a, and print the ptxas register / shared-memory lines;
  3. kernels: at every qwen3-4b projection shape, at M = 4 (decode) and
     M = 64 (a prefill bucket), hold mx_matmul (mxint8, mxfp8) and
     mx_matmul_int4 (mxint4) against their plain PyTorch versions on the
     same card tensors (rtol 1e-4, atol 1e-4 * max|plain|: both accumulate
     in f32, only the summation order differs), and time the kernel, the
     plain version and torch.matmul of x by the pre-densified bf16 weight
     (the nearest library call; it streams 2x / 4x the weight bytes);
  4. serving: qwen3-4b at full width (random weights from a seeded
     generator) -> MXINT8 anchor -> save_anchor / load_anchor ->
     ElasticEngine(batch_slots=4, max_len=512) serves 8 greedy requests at
     mxint8 and at mxint4 through the kernels, with launch counts read off
     the kernel wrappers, and the same requests through the densify
     contract as the reference.
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
# qwen3-4b projections (K, N) and how many of each one layer runs.
PROJ_SHAPES = {(2560, 4096): 1, (2560, 1024): 2, (4096, 2560): 1,
               (2560, 9728): 2, (9728, 2560): 1}
PROJ_PER_LAYER = sum(PROJ_SHAPES.values())          # 7
KERNEL_CASES = (("mx_matmul", "mxint8"), ("mx_matmul", "mxfp8"),
                ("mx_matmul_int4", "mxint4"))
TPU_KERNEL = {
    "mx_matmul": "src/repro/kernels/mx_matmul.py:54 mx_matmul_pallas",
    "mx_matmul_int4": "src/repro/kernels/mx_matmul.py:108 "
                      "mx_matmul_int4_pallas",
}
FUSED_TOL = 0.05   # max|fused - densify| <= 5% of max|densify| (bf16 rounds
#                    each projection's output at different places)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_time_ms(fn, n_iter: int) -> float:
    """Device time per call of ``fn(i)``: ``n_iter`` calls captured in one
    CUDA graph, replayed between CUDA events. The graph takes the host's
    launch cost out, so this is the card's time for the work itself."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):                      # warm up outside the graph
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_iter):
            fn(i)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n_iter
    del graph
    return ms


# ---------------------------------------------------------------------------
def phase_card():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0 = {torch.cuda.get_device_name(0)}; "
        f"count = {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import mx_matmul
    mx_matmul.build()
    info = mx_matmul.build_info
    log(f"build: {info['seconds']:.1f} s{' (already built)' if info['cached'] else ''}"
        f" -> {info['path']}")
    for line in info["ptxas"]:
        log(f"  {line.strip()}")


def phase_kernels(seed: int):
    """Per-shape checks and times; returns the per-kernel aggregates for
    one layer's seven projections at decode (M = 4)."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import dequantize, quantize
    from repro_torch.kernels import mx_matmul, ref
    from repro_torch.serve.packed_params import pack_leaf_int4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    agg = {}
    log("kernel phase: device ms per call (CUDA graph of many calls, timed "
        "with CUDA events), rotating over weight copies > 50 MB L2")
    log(f"{'kernel':16s}{'fmt':8s}{'M':>4s}{'K':>6s}{'N':>6s}{'max_err':>11s}"
        f"{'ms':>9s}{'plain':>9s}{'torch_bf16':>11s}{'bound':>9s} by")
    for k, n in PROJ_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        for name, fname in KERNEL_CASES:
            t = quantize(w, get_format(fname, 32), axis=0)
            if name == "mx_matmul_int4":
                leaf = pack_leaf_int4(t)
                codes = leaf.packed
                kern, plain = mx_matmul.mx_matmul_int4, ref.ref_mx_matmul_int4
            else:
                codes = t.codes
                kern, plain = mx_matmul.mx_matmul, ref.ref_mx_matmul
            scales = t.scale_exp
            wbytes = codes.numel() + scales.numel()
            n_copy = max(1, min(64, math.ceil(128e6 / wbytes)))
            copies = [(codes.clone(), scales.clone()) for _ in range(n_copy)]
            w_bf16 = dequantize(t, torch.bfloat16)
            n_dense = max(1, min(16, math.ceil(128e6 / (2 * k * n))))
            dense = [w_bf16.clone() for _ in range(n_dense)]
            for m in (4, 64):
                x = (torch.randn((m, k), generator=gen, device=dev)
                     ).to(torch.bfloat16)
                got = kern(x, codes, scales, t.fmt)
                want = plain(x, codes, scales, t.fmt)
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, rtol=1e-4,
                                      atol=1e-4 * scale):
                    fail(f"{name}[{fname}] M={m} K={k} N={n}: max abs err "
                         f"{err:.3g} vs max|plain| {scale:.3g}")
                ms = cuda_time_ms(lambda i: kern(
                    x, copies[i % n_copy][0], copies[i % n_copy][1], t.fmt),
                    50)
                plain_ms = cuda_time_ms(
                    lambda i: plain(x, codes, scales, t.fmt), 5)
                lib_ms = cuda_time_ms(
                    lambda i: torch.matmul(x, dense[i % n_dense]), 50)
                nbytes = wbytes + m * k * 2 + m * n * 4
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = 2 * m * k * n / BF16_FLOP_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                log(f"{name:16s}{fname:8s}{m:4d}{k:6d}{n:6d}{err:11.3g}"
                    f"{ms:9.4f}{plain_ms:9.4f}{lib_ms:11.4f}{bound:9.4f} {by}")
                a = agg.setdefault((name, fname), dict(
                    max_abs_err=0.0, max_err=0.0, ms=0.0, plain_ms=0.0,
                    library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0))
                a["max_abs_err"] = max(a["max_abs_err"], err)
                a["max_err"] = max(a["max_err"], err / scale)
                if m == 4:
                    mult = PROJ_SHAPES[(k, n)]
                    for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                     ("library_ms", lib_ms),
                                     ("bound_ms", bound),
                                     ("t_bytes", t_bytes),
                                     ("t_ops", t_ops)):
                        a[key] += mult * val
            del copies, dense
            torch.cuda.empty_cache()
    for (name, fname), a in agg.items():
        log(f"one layer's {PROJ_PER_LAYER} projections at M=4, "
            f"{name}[{fname}]: {a['ms']:.4f} ms (bound {a['bound_ms']:.4f} "
            f"ms, {100 * a['bound_ms'] / a['ms']:.1f}% of it; plain "
            f"{a['plain_ms']:.4f} ms; torch bf16 {a['library_ms']:.4f} ms)")
    return agg


def _requests(vocab: int, seed: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(16, 201))).astype(np.int32),
        max_new=16) for i in range(8)]


def phase_serving(n_layers: int, seed: int):
    import dataclasses

    import torch
    from repro_torch.checkpoint.anchor_ckpt import load_anchor, save_anchor
    from repro_torch.configs import get_config
    from repro_torch.core.anchor import make_anchor
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels.dispatch import make_qmm
    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.serve.engine import ElasticEngine

    cfg = get_config("qwen3-4b")
    if n_layers != cfg.n_layers:
        log(f"DEPTH CUT: serving {n_layers} of {cfg.n_layers} layers "
            "(widths unchanged)")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    log(f"serving phase: {cfg.name} d_model={cfg.d_model} "
        f"layers={cfg.n_layers} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    anchor = make_anchor(params, QATConfig(anchor="mxint8"), device="cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"init + make_anchor: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nbytes = save_anchor(os.path.join(tmp, "anchor"), anchor)
        t_save = time.perf_counter() - t0
        del anchor
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        anchor = load_anchor(os.path.join(tmp, "anchor"), device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    log(f"anchor checkpoint: {nbytes / 1e9:.3f} GB, save {t_save:.1f} s, "
        f"load {t_load:.1f} s")

    api = make_model(cfg)
    fused = ElasticEngine(api, anchor, batch_slots=4, max_len=512,
                          device="cuda")
    dense = ElasticEngine(api, anchor, batch_slots=4, max_len=512,
                          fused=False, device="cuda")
    launches = {}
    for fmt, kernel in (("mxint8", "mx_matmul"),
                        ("mxint4", "mx_matmul_int4")):
        weights = fused.weights_for(fmt)           # build outside the timing
        dense.weights_for(fmt)
        # ---- first-step logits: kernel contract vs the densify contract
        prompt = _requests(cfg.vocab, seed)[0].prompt
        batch = {"tokens": torch.as_tensor(prompt[None], device="cuda")}
        got = {}
        for mode in ("kernel", "densify"):
            mapi = api.with_qmm(make_qmm(mode))
            cache = mapi.init_cache(1, 512, device="cuda")
            lg, cache, clen = mapi.prefill_slot(weights, batch, cache, 0)
            nxt = torch.argmax(lg)[None, None].to(torch.int32)
            lg2, _ = mapi.serve_step(weights, {"tokens": nxt}, cache,
                                     clen[None])
            got[mode] = (lg.float(), lg2[0].float())
        for step, (a, b) in enumerate(zip(got["kernel"], got["densify"])):
            diff = float((a - b).abs().max())
            ref_max = float(b.abs().max())
            log(f"{fmt} step {step} logits: max|kernel - densify| = "
                f"{diff:.4g}, max|densify| = {ref_max:.4g}, argmax "
                f"{int(a.argmax())} vs {int(b.argmax())}")
            if not (torch.isfinite(a).all() and diff <= FUSED_TOL * ref_max):
                fail(f"{fmt} step {step}: kernel logits differ from densify "
                     f"by {diff:.4g} > {FUSED_TOL} * {ref_max:.4g}")

        # ---- the engine, through the kernels: counts read off the wrappers
        reqs = _requests(cfg.vocab, seed)
        before = dict(fused.stats())
        mx_matmul.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.generate(reqs, fmt_override=fmt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(mx_matmul.launches)
        st = fused.stats()
        steps = (st["prefills"] - before["prefills"]) \
            + (st["ticks"] - before["ticks"])
        ticks = st["ticks"] - before["ticks"]
        want = PROJ_PER_LAYER * cfg.n_layers * steps
        other = "mx_matmul_int4" if kernel == "mx_matmul" else "mx_matmul"
        log(f"{fmt}: launches {counts} over {steps} steps "
            f"({st['prefills'] - before['prefills']} prefills + {ticks} "
            f"decode ticks; want {want} = {PROJ_PER_LAYER} x {cfg.n_layers} "
            f"per step)")
        if counts[kernel] != want or counts[other] != 0:
            fail(f"{fmt}: {kernel} launched {counts[kernel]} times, want "
                 f"{want}; {other} {counts[other]}, want 0")
        launches[kernel] = counts[kernel]
        bad = [r.rid for r in reqs if r.status.value != "completed"
               or len(r.out_tokens) != 16]
        if bad or st["nonfinite_logit_rows"] != before["nonfinite_logit_rows"]:
            fail(f"{fmt}: requests {bad} incomplete or non-finite logits "
                 f"({st['nonfinite_logit_rows']})")
        if st["prefills"] - before["prefills"] <= fused.slots:
            fail(f"{fmt}: no slot was re-admitted")
        # ---- one decode step at 4 live slots: driven from the host as the
        # engine drives it, and replayed as a CUDA graph (device time only)
        sapi = api.with_qmm(make_qmm("kernel"))
        cache = sapi.init_cache(4, 512, device="cuda")
        clen = torch.full((4,), 200, dtype=torch.int32, device="cuda")
        toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")

        def step(i):
            return sapi.serve_step(weights, {"tokens": toks}, cache, clen)

        step(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 5
        dev_ms = cuda_time_ms(step, 3)
        del cache
        log(f"{fmt} decode step (4 slots, cache_len 200): host-driven "
            f"{host_ms:.2f} ms, device time {dev_ms:.2f} ms (CUDA graph "
            f"replay); the card idles {100 * (1 - dev_ms / host_ms):.0f}% "
            "of a host-driven step")

        ref_reqs = _requests(cfg.vocab, seed)
        dense.generate(ref_reqs, fmt_override=fmt)
        same = sum(x == y for r, q in zip(reqs, ref_reqs)
                   for x, y in zip(r.out_tokens, q.out_tokens))
        total = sum(len(r.out_tokens) for r in reqs)
        prefill_ms = (st["prefill_s"] - before["prefill_s"]) * 1e3 \
            / (st["prefills"] - before["prefills"])
        decode_ms = (st["decode_s"] - before["decode_s"]) * 1e3 / ticks
        log(f"{fmt}: {len(reqs)} requests x 16 tokens in {wall:.2f} s = "
            f"{total / wall:.1f} tok/s; prefill {prefill_ms:.1f} ms/request "
            f"(prompts 16-200, pow2 buckets); decode {decode_ms:.2f} ms/step "
            f"(4 slots); weight-stream bytes {st['weight_bytes'][fmt]}; "
            f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB; greedy tokens equal to the densify contract: "
            f"{same}/{total} ({100 * same / total:.1f}%)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=36,
                    help="qwen3-4b depth to serve (default: all 36)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke FAILED: no CUDA device; this script measures the "
              "port on a card and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    t_all = time.perf_counter()
    phase_card()
    phase_build()
    agg = phase_kernels(args.seed)
    launches = phase_serving(args.layers, args.seed)
    from repro_torch.kernels import mx_matmul
    from repro_torch.kernels.mx_matmul import SOURCE
    source = os.path.relpath(SOURCE, os.path.dirname(os.path.abspath(
        __file__)))
    kernels = []
    for (name, fname), a in agg.items():
        if fname == "mxfp8":
            continue              # the serving path runs mx_matmul at mxint8
        kernels.append({
            "name": name, "format": fname, "route": "cuda",
            "source": source, "replaces": TPU_KERNEL[name],
            "launches": launches[name],
            "max_abs_err": a["max_abs_err"], "max_err": a["max_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"],
            "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"]
            else "operations",
            "library_ms": a["library_ms"],
            "timed_as": f"one layer's {PROJ_PER_LAYER} qwen3-4b projections "
                        "at M=4",
        })
    if set(mx_matmul.launches) != {k["name"] for k in kernels}:
        fail(f"kernel record {[k['name'] for k in kernels]} does not cover "
             f"every wrapper {sorted(mx_matmul.launches)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
