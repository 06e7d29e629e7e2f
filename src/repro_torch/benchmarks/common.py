"""Shared benchmark helpers: timing + CSV output convention.

Every benchmark prints ``name,us_per_call,derived`` rows (one per paper-table
cell); `derived` carries the table's own metric (compression ratio, GB/s, ...).
Times are host-clock seconds of the host API, each call between two
synchronisations of the card.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-time per call in seconds (after ``warmup`` calls)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def emit(name: str, seconds: float, derived) -> None:
    print(f"{name},{seconds * 1e6:.1f},{derived}")


def throughput_gbs(nbytes: int, seconds: float) -> float:
    return nbytes / max(seconds, 1e-12) / 1e9


def resolve_device(device=None) -> torch.device:
    """The device a sweep runs on: the card unless ``"cpu"`` is asked for."""
    from repro_torch.core.lzss import resolve_device as resolve

    return resolve(device)


def platform_fields(device) -> dict:
    """The JSON's provenance: ``platform`` ("cuda" or "cpu"), whether the
    kernels ran as their plain versions (``interpret_mode``, the
    reference's key), and on ``cuda`` the card's name and power limit as
    nvidia-smi gives them."""
    dev = torch.device(device)
    out = {"platform": dev.type, "interpret_mode": dev.type != "cuda"}
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            )
            card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
        except (OSError, IndexError, subprocess.SubprocessError):
            card = None
        out["card"] = card or "nvidia-smi failed"
    return out
