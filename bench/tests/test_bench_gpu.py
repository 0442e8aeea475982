"""Card-only tests (marked ``gpu``; each decides inside itself whether a
card is there and skips otherwise).

- ``bench/run.py`` runs a cell end to end and prints the contract's line;
- each serving cell's control, the program serving one MXINT format below
  the cell's (``control_format``) and judged against the reference at the
  cell's format, comes out not correct at the cell's own size.
"""
import json
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_run_py_prints_the_contract_line():
    _card()
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         str(2 ** 31 + 17), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _card()
    from bench import run as R
    from bench.harness import spec
    c = spec.load_cell(cell)
    rec = R.run_cell(cell, 2 ** 31 + 23, 3.0, False, "cuda",
                     fmt=c["control_format"])
    assert not rec["correct"], rec["checks"]
