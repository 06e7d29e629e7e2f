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

from bench import harness, manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def small_config(man: dict, cell_name: str, rows=32, cols=64, fields=2) -> dict:
    """The cell's configuration at a size the CPU's plain path runs quickly:
    its generator's ``small(spec, elements, fields)`` where it defines one,
    else ``rows`` x ``cols`` elements a field."""
    cfg = copy.deepcopy(manifest.config(man, manifest.cell(man, cell_name)["config"]))
    gen = harness.load_module("gen", cfg["data"]["generator"])
    if hasattr(gen, "small"):
        cfg["data"] = gen.small(cfg["data"], elements=rows * cols, fields=fields)
    else:
        cfg["data"].update(rows=rows, cols=cols, fields=fields)
    return cfg


def small_traffic(man: dict, cell_name: str) -> dict:
    """The cell's traffic mix at the tests' small sizes: its op's
    ``small(traffic)`` where the op defines one, else the mix itself."""
    traffic = manifest.traffic(manifest.cell(man, cell_name)["traffic"])
    op = harness.load_module("ops", traffic["op"])
    return op.small(traffic) if hasattr(op, "small") else traffic


def small(man: dict, cell_name: str) -> dict:
    """``run_cell``'s keywords for a run of the cell at the small sizes."""
    return dict(config=small_config(man, cell_name), traffic=small_traffic(man, cell_name))


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
