"""Anchor-format (packed MX) checkpoints — the deployment artifact.

Same on-disk format as ``repro/checkpoint/anchor_ckpt.py``: one
``anchor.npz`` holding element codes bit-packed at their true width
(``core/packed.py``), int8 E8M0 scales and float leaves, plus an
``index.json``, all keyed by JAX ``keystr`` paths. Either package reads what
the other wrote.

The block size of each quantized leaf is read off its own shapes (block-axis
length over the scales' last dim). The JAX writer records the registry
default block size in ``index.json`` whatever the anchor was quantized at,
so trusting that field would misread a bs=16 anchor.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.packed import pack_np, unpack_np
from repro_torch.devices import resolve_device


def save_anchor(path: str, model: AnchorModel) -> int:
    """Write a packed anchor checkpoint. Returns bytes written."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    block_size = next((t.fmt.block_size for t in model.quantized.values()),
                      get_format(model.fmt_name).block_size)
    arrays: Dict[str, np.ndarray] = {}
    index = {"fmt": model.fmt_name, "block_size": block_size,
             "quantized": {}, "raw": []}
    for k, t in model.quantized.items():
        buf, shape = pack_np(t.codes.cpu().numpy(), t.fmt.bits)
        arrays[f"q:{k}:codes"] = buf
        arrays[f"q:{k}:scales"] = t.scale_exp.cpu().numpy()
        index["quantized"][k] = {
            "shape": list(shape), "bits": t.fmt.bits,
            "block_axis": t.block_axis,
            "signed": t.fmt.kind == "int",
            "scale_shape": list(t.scale_exp.shape),
        }
    for k, w in model.raw.items():
        arrays[f"r:{k}"] = w.cpu().numpy()
        index["raw"].append(k)
    np.savez(os.path.join(tmp, "anchor.npz"), **arrays)
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return sum(a.nbytes for a in arrays.values())


def load_anchor(path: str, *, device="cuda") -> AnchorModel:
    dev = resolve_device(device)
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    quantized = {}
    with np.load(os.path.join(path, "anchor.npz")) as z:
        for k, meta in index["quantized"].items():
            shape = tuple(meta["shape"])
            codes = unpack_np(z[f"q:{k}:codes"], meta["bits"], shape,
                              meta["signed"])
            scales = z[f"q:{k}:scales"]
            bs = shape[meta["block_axis"]] // scales.shape[-1]
            quantized[k] = MXTensor(
                codes=torch.from_numpy(codes).to(dev),
                scale_exp=torch.from_numpy(scales.astype(np.int8)).to(dev),
                fmt=get_format(index["fmt"], bs),
                block_axis=meta["block_axis"])
        raw = {k: torch.from_numpy(np.array(z[f"r:{k}"])).to(dev)
               for k in index["raw"]}
    return AnchorModel(quantized=quantized, raw=raw, fmt_name=index["fmt"])
