"""pytest settings of the benchmark's own tests (`python -m pytest benchmark -q`)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skips itself where there is none")
