"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py`` with the same flags, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels). Reduced configs by default, ``--full`` for the published widths.
Auto-resumes from the latest checkpoint under ``--ckpt``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.formats import TRAIN_FORMATS_MXFP, TRAIN_FORMATS_MXINT
from repro_torch.core.qat import QATConfig
from repro_torch.data.pipeline import DataConfig, LMDataset
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, run_training


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--formats", default="mxint",
                    choices=["mxint", "mxfp", "none"])
    ap.add_argument("--schedule", default="multiformat")
    ap.add_argument("--anchor", default=None,
                    help="anchor format for §3.5 training (e.g. mxint8)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--moment-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    fmts = {"mxint": TRAIN_FORMATS_MXINT, "mxfp": TRAIN_FORMATS_MXFP,
            "none": ()}[args.formats]
    qat = QATConfig(formats=fmts, anchor=args.anchor, block_size=32) \
        if fmts else None
    api = get_model(cfg, qat=qat)
    data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch))
    opt = AdamWConfig(lr=args.lr,
                      moment_dtype=torch.bfloat16
                      if args.moment_dtype == "bf16" else torch.float32)
    out = run_training(
        api, data, opt,
        LoopConfig(total_steps=args.steps,
                   schedule=args.schedule if fmts else "fp",
                   ckpt_dir=args.ckpt),
        on_step=lambda s, m: print(
            f"step {s} fmt={m['fmt_idx']} loss={m['loss']:.4f}")
        if s % 10 == 0 else None,
        device=args.device)
    h = out["history"]
    print(f"finished at step {out['last_step']}; "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}" if h else "noop")


if __name__ == "__main__":
    main()
