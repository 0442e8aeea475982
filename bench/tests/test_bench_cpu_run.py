"""A whole run of a cell laid out like each real cell (the fixture cells:
starcoder2-3b's and mixtral-8x7b's layers at test widths), on the CPU,
skipping only the look for a card: correct when the program is sound, and
not correct when the timed path is broken underneath it (a served token
altered where it is produced)."""
import numpy as np
import pytest

from bench import run as R
from bench.harness import spec
from bench.tests.conftest import FIXTURE_BENCHMARK, FIXTURES

CELLS = ["tiny-dense.decode", "tiny-moe.decode", "tiny-dense.prefill"]
SEED = 2 ** 31 + 99


def _run(cell):
    seconds = 2.0 if "prefill" in cell else 0.5
    return R.run_cell(cell, SEED, seconds, False, "cpu", roots=[FIXTURES],
                      benchmark=spec.load_benchmark(FIXTURE_BENCHMARK))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rec = _run(cell)
    assert rec["correct"], rec["checks"]
    assert rec["check_detail"]["tokens"] >= 4
    e2e, _ = spec.cell_metrics(spec.load_benchmark(FIXTURE_BENCHMARK), cell)
    assert sorted(rec["metrics"]) == sorted(e2e)
    assert all(v["value"] > 0 for v in rec["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_is_caught(cell, monkeypatch):
    from repro_torch.serve import engine as E
    orig = E.ElasticEngine._drain_tick

    def altered(self, logits, admit):
        d = orig(self, logits, admit)
        d.drained = (np.asarray(d.drained) + 1) % logits.shape[-1]
        return d

    monkeypatch.setattr(E.ElasticEngine, "_drain_tick", altered)
    rec = _run(cell)
    assert not rec["correct"], rec["checks"]

