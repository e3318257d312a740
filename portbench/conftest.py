"""pytest settings of the benchmark's own tests (``python -m pytest
portbench -q``): the ``cuda`` marker, as the repository's tests register
it, for the tests that need the card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
