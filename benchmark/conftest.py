"""pytest settings of the benchmark's own tests (`benchmark/tests/`): the
repo root on the import path, and the `card` marker of tests that need a
CUDA card, which skip inside the test where there is none. Run them with

    python -m pytest benchmark/tests -q

and on the card with `python -m pytest benchmark/tests -q -m card`."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")
