"""One nvcc build of every CUDA source of the port into one shared library.

Every ``csrc/*.cu`` file has a plain C interface (``*.cuh`` headers hold
what several share); each is compiled for
``sm_90a`` into an object by its own ``nvcc`` (all started together), and
the objects are linked into one ``.so`` that the kernel wrappers load with
``ctypes``. The library goes into ``build/repro_torch/`` at the repository
root, named by a hash of every source and the flags, so an edited source
rebuilds and an unchanged tree loads what is there. ``build_info`` keeps the
seconds the build took and the ptxas lines (registers, shared memory,
spills) of every kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


def _ptxas_lines(log: str) -> List[str]:
    return [ln for ln in log.splitlines()
            if "registers" in ln or "smem" in ln or "spill" in ln
            or "Compiling entry" in ln]


def _compile(srcs: List[pathlib.Path], out: pathlib.Path) -> str:
    """Objects in parallel, then one link; returns the compilers' output."""
    nvcc = _nvcc()
    tmp_dir = out.with_suffix(f".{os.getpid()}.d")
    tmp_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = tmp_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        text = proc.communicate()[0]
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """Compile (once per hash of the sources and flags) and load the
    library holding every kernel of the port."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # sources and headers
        digest.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:12]}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    cached = out.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log_path.write_text(_compile(srcs, out))
    log = log_path.read_text() if log_path.exists() else ""
    _lib = ctypes.CDLL(str(out))
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=cached, sources=[s.name for s in srcs],
                      ptxas=_ptxas_lines(log))
    return _lib
