"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`cuda` that need the card (they skip without one):

    python -m pytest portbench/tests -q
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs at the cells' own "
        "sizes); skips without one")
