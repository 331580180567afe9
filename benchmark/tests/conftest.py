"""CPU tests of the benchmark (``python -m pytest benchmark/tests``). Tests
that need the card carry the ``cuda`` marker and skip inside the test
where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips inside the test)")
