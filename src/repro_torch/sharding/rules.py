"""Logical axis rules of the port's device meshes.

Only what the batch layer needs is here; the model-parallel rules of the
reference (``repro/sharding/rules.py``) come with the models.  The port's
mesh is a sequence of devices on one axis, ``"data"``.
"""

from __future__ import annotations

MESH_AXES = ("data",)  # the axis names of every port mesh


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension: the reference's rule gives
    ("pod", "data") on a mesh with a pod axis, else ("data",), and every
    port mesh has the one axis "data"."""
    del mesh
    return ("data",)
