"""Make ``pytest -q`` work from a clean checkout: put ``src`` on sys.path
(equivalent to ``PYTHONPATH=src`` or an editable install), and register the
tier markers CI splits on (``-m "not slow and not device"`` is the fast
tier-1 job; the kernels job runs the marker-gated remainder)."""
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "device: exercises the Pallas kernel (device='jax') paths — slower "
        "to trace/compile; run via the marker-gated CI job")
    config.addinivalue_line(
        "markers",
        "slow: long-running end-to-end tests (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
