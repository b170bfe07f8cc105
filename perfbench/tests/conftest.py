"""Shared fixtures of the benchmark's tests."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: The cells' sizes for a CPU rehearsal: every width of the run shrunk, the
#: program and the comparison unchanged.
SMALL = {
    "logistic_regression": {"num_data": 200, "dim": 5, "max_tree_depth": 4, "num_steps": 2},
}


def small(cell) -> dict:
    """Overrides that shrink a cell for the CPU."""
    from perfbench import harness

    cfg = harness.resolve(harness.load_manifest(), cell).config
    return {"config": SMALL[cfg["target"]], "traffic": {"chains": 16, "check_chains": 8}}


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
