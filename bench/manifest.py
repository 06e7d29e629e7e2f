"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
both are found by name under ``bench/``: ``configs/<config name>.json``
(whose ``file`` the manifest also gives) and ``traffic/<traffic>.json``.
"""

from __future__ import annotations

import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(path=None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def reported(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced.  A metric with ``workloads`` is
    reported in those cells; a per-layer one without, wherever the
    end-to-end metric it moves is."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def here(m):
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in manifest["per_layer"] if here(m)]
