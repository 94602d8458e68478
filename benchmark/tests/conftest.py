"""The benchmark's own tests: ``python3 -m pytest benchmark/tests -q`` from
the root of the repository (CPU; the ``gpu`` test skips without a card)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")
