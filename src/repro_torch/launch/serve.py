"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Counterpart of ``repro/launch/serve.py`` with the same flags, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
Loads the anchor checkpoint at ``--anchor-ckpt`` when that directory exists
(one the JAX package saved reads the same), else makes an MXINT8 anchor
from seeded random weights and, given ``--anchor-ckpt``, saves it there;
then serves ``--requests`` greedy requests of 8 random prompt tokens and
prints the first four streams and the engine's stats. An encoder-decoder
config is refused by the engine (ROADMAP C.12: a ``Request`` carries no
frame embeddings; the reference fails at its first admission).

``--reduced`` (the default) serves the reduced test widths. The reference
declares the flag ``store_true`` with ``default=True``, so it can never be
turned off; here ``--no-reduced`` serves the published widths (ROADMAP
C.7).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.checkpoint.anchor_ckpt import load_anchor, save_anchor
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.anchor import make_anchor
from repro_torch.core.formats import get_format
from repro_torch.core.qat import QATConfig
from repro_torch.models import get_model
from repro_torch.serve.engine import ElasticEngine, Request
from repro_torch.serve.policy import FormatPolicy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--anchor-ckpt", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--fmt", default=None,
                    help="pin a format instead of the load policy")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    api = get_model(cfg)
    qat = QATConfig(formats=("mxint4", "mxint8"), anchor="mxint8",
                    block_size=32)

    if args.anchor_ckpt and os.path.isdir(args.anchor_ckpt):
        anchor = load_anchor(args.anchor_ckpt, device=args.device)
        print(f"loaded anchor checkpoint {args.anchor_ckpt} "
              f"({anchor.fmt_name})")
    else:
        params = api.init_params(0, device=args.device)
        anchor = make_anchor(params, qat, get_format("mxint8", 32),
                             device=args.device)
        del params
        if args.anchor_ckpt:
            n = save_anchor(args.anchor_ckpt, anchor)
            print(f"wrote anchor checkpoint ({n / 1e6:.1f} MB)")

    eng = ElasticEngine(api, anchor, batch_slots=args.slots, max_len=96,
                        policy=FormatPolicy(anchor="mxint8"),
                        device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    eng.generate(reqs, fmt_override=args.fmt)
    for r in reqs[:4]:
        print(f"req {r.rid}: fmt={r.fmt_used} out={r.out_tokens}")
    print("engine:", eng.stats())


if __name__ == "__main__":
    main()
