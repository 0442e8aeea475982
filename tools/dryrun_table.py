#!/usr/bin/env python3
"""Tabulate a dry-run sweep (``repro_torch.launch.dryrun``'s records) beside
the analytic cost model (``repro_torch.launch.costmodel``).

    PYTHONPATH=src python tools/dryrun_table.py [--dir out/dryrun]

One markdown row per (arch, shape, variant), the two production meshes
side by side as ``16x16 / pod2x16x16``, the variants other than
``baseline`` of one (arch, shape) in one row, each entry ``a · b`` where
they differ (in the variants' order): the status (a refused or failed
cell with its reason), per-rank argument and temp GiB and whether their
sum fits an H100's 80 GB (80e9 bytes), the record's FLOPs times the ranks
against ``flops_train`` / ``_prefill`` / ``_decode`` (a ratio), the
per-rank ring-weighted collective bytes against ``collectives_*``'s total
(GB / GB), and the trace's seconds. An arch refused at every cell is one
row.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import costmodel as cm

H100_BYTES = 80e9
MESHES = {"16x16": cm.MeshDesc(1, 16, 16),
          "pod2x16x16": cm.MeshDesc(2, 16, 16)}
GIB = 2 ** 30


def model_terms(rec):
    """(cost-model flops, cost-model collective bytes per card) of a cell."""
    cfg, shape = get_config(rec["arch"]), SHAPES[rec["shape"]]
    mesh = MESHES[rec["mesh"]]
    variant = rec["variant"]
    if shape.kind == "train":
        return (cm.flops_train(cfg, shape)["total"],
                cm.collectives_train(cfg, shape, mesh)["total"])
    if shape.kind == "prefill":
        return (cm.flops_prefill(cfg, shape)["total"],
                cm.collectives_prefill(cfg, shape, mesh)["total"])
    bits = 8 if "w8" in variant else 4 if "w4" in variant else 16
    stationary = variant.endswith(("tp", "scan"))
    return (cm.flops_decode(cfg, shape)["total"],
            cm.collectives_decode(cfg, shape, mesh,
                                  weight_stationary=stationary,
                                  weight_bits=bits)["total"])


def cell(rec):
    """The row's entries for one mesh."""
    if rec["status"] != "ok":
        return None
    mem = rec["memory"]
    arg = mem["argument_size_in_bytes"]
    temp = mem["temp_size_in_bytes"]
    flops, coll = model_terms(rec)
    return {"arg": arg / GIB, "temp": temp / GIB,
            "fits": "yes" if arg + temp <= H100_BYTES else "no",
            "ratio": rec["flops"] * rec["n_devices"] / flops,
            "coll": rec["collectives"]["total_weighted"] / 1e9,
            "coll_model": coll / 1e9, "s": rec["compile_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="out/dryrun")
    args = ap.parse_args(argv)
    rows = defaultdict(dict)
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        arch, shape, mesh, variant = os.path.basename(path)[:-5].split("__")
        rec.setdefault("arch", arch)
        rec.setdefault("shape", shape)
        rec.setdefault("mesh", mesh)
        rec.setdefault("variant", variant)
        if rec["status"] == "skipped":
            continue
        rows[(arch, SHAPES[shape].seq_len, shape, variant)][mesh] = rec
    print("| arch | shape | variant | status | arg GiB | temp GiB | fits "
          "80 GB | FLOPs x ranks / model | coll GB (model) | trace s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    refused = defaultdict(set)
    merged = defaultdict(list)       # (arch, shape, baseline?) -> columns
    for (arch, _, shape, variant), by_mesh in sorted(
            rows.items(), key=lambda kv: (kv[0][0], list(SHAPES).index(
                kv[0][2]), kv[0][3] != "baseline", kv[0][3])):
        recs = [by_mesh.get(m) for m in MESHES]
        if all(r and r["status"] == "refused" for r in recs):
            refused[arch].add(recs[0]["reason"])
            continue
        cells = [cell(r) if r else None for r in recs]
        status = " / ".join(r["status"] if r else "-" for r in recs)
        bad = [r for r in recs if r and r["status"] != "ok"]
        if bad:
            status += ": " + bad[0].get("error", bad[0].get("reason", ""))

        def col(key, fmt):
            return " / ".join(fmt.format(c[key]) if c else "-" for c in cells)
        coll = " / ".join(f"{c['coll']:.3g} ({c['coll_model']:.3g})" if c
                          else "-" for c in cells)
        merged[(arch, shape, variant == "baseline")].append(
            [variant, status, col("arg", "{:.2f}"), col("temp", "{:.2f}"),
             col("fits", "{}"), col("ratio", "{:.3f}"), coll,
             col("s", "{:.1f}")])
    for (arch, shape, _), cols in merged.items():
        joined = [" · ".join(dict.fromkeys(c)) for c in zip(*cols)]
        print(f"| {arch} | {shape} | " + " | ".join(joined) + " |")
    for arch, reasons in sorted(refused.items()):
        print(f"| {arch} | every shape | every variant | refused: "
              f"{'; '.join(sorted(reasons))} | | | | | | |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
