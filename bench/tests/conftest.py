import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
FIXTURE_BENCHMARK = FIXTURES / "benchmark.json"
