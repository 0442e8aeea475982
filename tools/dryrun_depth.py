#!/usr/bin/env python3
"""Trace one dry-run cell with its config cut to its first N layers and
print the trace's seconds and a rank's bytes: a quick read of what one
layer of a cell costs to trace.

    PYTHONPATH=src python tools/dryrun_depth.py --arch llava-next-mistral-7b \\
        --shape train_4k --layers 1 [--mesh single|multi] [--variant sp]

Rank 0 of the production mesh over a fake world of its size, on ``meta``
tensors (``repro_torch.launch.dryrun.trace_cell``); widths, shapes and the
mesh are the cell's own, only the depth is cut.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    multi = args.mesh == "multi"
    t0 = time.perf_counter()
    with dryrun.fake_world(math.prod(PRODUCTION_MESHES[multi][0])):
        rec = dryrun.trace_cell(cfg, SHAPES[args.shape],
                                make_production_mesh(multi_pod=multi),
                                args.variant, device="cuda")
    mem = rec.get("memory", {})
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "layers": args.layers,
        "mesh": dryrun.mesh_tag(multi), "variant": args.variant,
        "status": rec["status"], "seconds": time.perf_counter() - t0,
        "argument_bytes": mem.get("argument_size_in_bytes"),
        "temp_bytes": mem.get("temp_size_in_bytes")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
