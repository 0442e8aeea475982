"""Training checkpoints: atomic, manifest-driven, keep-N, resumable.

Counterpart of ``repro/checkpoint/io.py`` with its on-disk layout, so each
package resumes the other's runs:
    <dir>/step_000000123/
        arrays.npz            flat keystr path -> array
        manifest.json         step, keys, dtypes, shapes, meta
    <dir>/LATEST              text file: "step_000000123"  (atomic rename)
Writes go to a tmp dir that is renamed into place, LATEST advances by an
atomic rename, and keep-N collects old steps only after it moved. numpy has
no bf16, so a bf16 array is stored as 2-byte raw records with the dtype
"bfloat16" in the manifest — how numpy writes the JAX package's bf16
arrays.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

MANIFEST = "manifest.json"
LATEST = "LATEST"


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def save(root: str, step: int, arrays: Dict[str, Any],
         extra_meta: Optional[Dict] = None, keep_n: int = 3) -> str:
    """Write ``{keystr path: tensor or array}`` as step ``step``."""
    os.makedirs(root, exist_ok=True)
    final = step_dir(root, step)
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    host = {k: _to_numpy(v) for k, v in arrays.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    dtypes = {k: "bfloat16" if isinstance(v, torch.Tensor)
              and v.dtype == torch.bfloat16 else str(host[k].dtype)
              for k, v in arrays.items()}
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                 for k, a in host.items()},
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    ltmp = os.path.join(root, LATEST + ".tmp")
    with open(ltmp, "w") as f:
        f.write(os.path.basename(final))
    os.rename(ltmp, os.path.join(root, LATEST))

    _gc(root, keep_n)
    return final


def _gc(root: str, keep_n: int):
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_")
                   and not d.endswith(".tmp") and ".tmp." not in d)
    for d in steps[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> Optional[int]:
    path = os.path.join(root, LATEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(root, name)):
        return None
    return int(name.split("_")[1])


def restore(root: str, step: Optional[int] = None):
    """``(arrays, manifest)`` of step ``step`` (None follows LATEST), the
    arrays keyed as they were saved; ``interop.train_state_from_numpy``
    turns a training state's arrays into the port's ``TrainState``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = step_dir(root, step)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    return arrays, manifest
