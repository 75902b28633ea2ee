"""CPU tests of the benchmark (python -m pytest benchmark/tests). Tests
that need a card carry the `card` marker and skip inside the test."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")
