"""Mesh construction (the PyTorch port).

A ``Mesh`` keeps the reference's axis names and sizes over torch devices:
``axis_names``, ``devices`` (an object array of that shape) and ``shape``
(``{axis: size}``), as ``runtime/elastic.py`` and the step builders read
them.  Iterating it gives its devices in order, so it is accepted wherever
the port takes ``mesh=`` (``sharding/batch.mesh_devices``).  The port runs
a model on one device, so every position holds ``device``: a mesh of two
pods on one card is two ``cuda:0``, as the gradient exchange takes it.

Defined as functions (never module-level constants), so importing this
module touches no device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import lzss


class Mesh:
    def __init__(self, shape: tuple, axis_names: tuple, device=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
        dev = lzss.resolve_device(device)
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(tuple(shape), dtype=object)
        self.devices.fill(dev)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __iter__(self):
        return iter(self.devices.flat)

    def __len__(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.devices.flat[0]})"


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 positions a pod; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, device=None) -> Mesh:
    """Small mesh over ``device`` (``None``: ``cuda``) — for tests and the
    launchers."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"), device)
    return Mesh((data, model), ("data", "model"), device)

