"""Finding a cell, its configuration, its traffic mix and its metrics by name.

Everything that belongs to one of them is a file of its own under a root
(``bench/`` itself, or a folder laid out the same way):

  cells/<cell>.json       which config, mix, formats, engine and check
  configs/<config>.json   the model as it is run, with its source and cuts
  traffic/<mix>.json      parameters of the one general generator
  metrics/<metric>.py     ``read(rec)``: the metric's value from a run's
                          record, or None where the run has nothing to read

Which metrics a cell reports is ``BENCHMARK.json``'s alone: each metric
whose ``workloads`` lists the cell, or that has no ``workloads``. A later
cell, config, mix or metric is a new file and its entries there; no
existing file changes. ``roots`` (where a function takes it) are searched
before ``bench/``.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOTS: List[pathlib.Path] = [BENCH]
BENCHMARK = BENCH.parent / "BENCHMARK.json"


def load_benchmark(path=None) -> Dict:
    """``BENCHMARK.json`` at the root of the checkout, or the file at
    ``path`` laid out the same way."""
    return json.loads(pathlib.Path(path or BENCHMARK).read_text())


def workload(benchmark: Dict, cell: str) -> Dict:
    for w in benchmark["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload named {cell!r} in the benchmark")


def cell_metrics(benchmark: Dict, cell: str) -> Tuple[List[str], List[str]]:
    """(end-to-end, per-layer) names of the metrics ``cell`` reports."""
    workload(benchmark, cell)
    return tuple([m["name"] for m in benchmark[kind]
                  if cell in m.get("workloads", [cell])]
                 for kind in ("end_to_end", "per_layer"))


def _find(kind: str, name: str, suffix: str,
          roots: Optional[Sequence[pathlib.Path]] = None) -> pathlib.Path:
    search = [*(roots or ()), *ROOTS]
    for root in search:
        p = pathlib.Path(root) / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise KeyError(f"no {kind[:-1]} named {name!r} under "
                   f"{[str(r) for r in search]}")


def load_json(kind: str, name: str, roots=None) -> Dict:
    return json.loads(_find(kind, name, ".json", roots).read_text())


def load_cell(name: str, roots=None) -> Dict:
    """The cell with its ``config`` and ``traffic`` resolved to their files'
    contents (``config_name`` / ``traffic_name`` keep the names)."""
    cell = dict(load_json("cells", name, roots))
    cell["name"] = name
    cell["config_name"] = cell["config"]
    cell["traffic_name"] = cell["traffic"]
    cell["config"] = load_json("configs", cell["config"], roots)
    cell["traffic"] = load_json("traffic", cell["traffic"], roots)
    return cell


def metric_reader(name: str, roots=None):
    """The module of ``metrics/<name>.py`` (names may hold dots)."""
    path = _find("metrics", name, ".py", roots)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(names: Sequence[str], rec: Dict, roots=None) -> Dict:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for n in names:
        mod = metric_reader(n, roots)
        v = mod.read(rec)
        if v is not None:
            out[n] = {"value": float(v), "unit": mod.UNIT}
    return out
