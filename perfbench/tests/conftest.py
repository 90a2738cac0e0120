"""The benchmark's own tests (``python -m pytest perfbench/tests``).

They run on the CPU at 16-32 pixels square; tests that need a CUDA card
carry the ``gpu`` marker and skip from inside the test where there is
none.  Nothing here imports JAX.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)      # the workers and the ranks share the cores


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips from inside the test "
        "where there is none")
