"""What the benchmark's own tests share (run them with
``PYTHONPATH=.:src python -m pytest bench/tests``)."""

from __future__ import annotations

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def small_config(man: dict, cell_name: str, rows=32, cols=64, fields=2) -> dict:
    """The cell's configuration at a size the CPU's plain path runs quickly."""
    cfg = copy.deepcopy(manifest.config(man, manifest.cell(man, cell_name)["config"]))
    cfg["data"].update(rows=rows, cols=cols, fields=fields)
    return cfg


@pytest.fixture(scope="session")
def man():
    return manifest.load()


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
