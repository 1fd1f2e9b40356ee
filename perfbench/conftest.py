"""pytest settings of the benchmark's own tests (``python -m pytest
perfbench/tests``): the program's sources on the path, and the ``card``
marker for tests that need a CUDA device (decided inside the ``cuda``
fixture, never at import)."""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(_ROOT, "src"), _ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    """Each test's runs write under its own TMPDIR."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
