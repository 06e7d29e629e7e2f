"""Logical-axis -> mesh-axis sharding rules.

Model code annotates every param with logical axis names; this module maps
them onto the reference's production mesh (("data","model") or
("pod","data","model")).  The port runs a model on one device, so these
rules are metadata: a spec is a plain tuple of mesh-axis names where the
reference builds ``PartitionSpec(*parts)``, with the same normalisation (a
one-name tuple entry becomes the bare name).  ``constrain_batch`` returns
its input, as the reference's does without a mesh context.

The port's codec mesh is a sequence of devices on one axis, ``"data"``;
``batch_spec`` and ``zero_spec`` take the data axis's size from its length.
A ``launch/mesh.Mesh`` (the reference's axis names and sizes over torch
devices) is such a sequence too; for it they read the named axes' sizes,
and ``batch_axes`` follows the reference's rule.

Where the reference builds a ``NamedSharding``, ``params_shardings`` and
``zero_shardings`` give a ``Placement``: the device a leaf lives on (the
mesh's first: the port runs a model on one device) and its spec.
"""

from __future__ import annotations

import dataclasses

import torch

MESH_AXES = ("data",)  # the axis names of every port mesh

LOGICAL_RULES = {
    # embeddings
    "vocab": "model",  # output/tied table rows
    "vocab_in": "data",  # input table rows (d sharded on model)
    "embed_sharded": "model",
    "embed": "data",  # d_model inside weights: FSDP over data
    "embed_unsharded": None,
    "embed_out": "data",
    # attention
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "lora": None,  # MLA latent dims (replicated)
    # mlp / moe
    "ffn": "model",
    "experts": "model",  # expert parallelism
    "expert_ffn": None,
    # ssm
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_inner_conv": None,
    "state": None,
    "conv": None,
    # stacking
    "layers": None,
}


def _spec(*parts) -> tuple:
    """``PartitionSpec(*parts)`` as a tuple: a one-name tuple entry is the
    bare name, as the reference's specs normalise it."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(s, str) for s in x)


def _map_axes(fn, tree):
    """Apply ``fn`` to every axes tuple of a tree of dicts and lists (the
    reference's nested axes, or the port's flat ``param_axes`` dict)."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    raise TypeError(f"not an axes tree leaf: {tree!r}")


# Weight-FSDP toggle: when off, weight d_model/vocab_in dims replicate over
# the data axis.
_FSDP_AXES = ("embed", "vocab_in", "embed_out")
_FSDP = True


def set_fsdp(enabled: bool):
    global _FSDP
    _FSDP = bool(enabled)


def fsdp_enabled() -> bool:
    return _FSDP


def spec_for(axes: tuple) -> tuple:
    def one(a):
        if a in _FSDP_AXES and not _FSDP:
            return None
        return LOGICAL_RULES.get(a, None)

    return _spec(*(one(a) for a in axes))


def _devices(mesh) -> tuple:
    from repro_torch.sharding.batch import mesh_devices

    return mesh_devices(mesh)


def _axis_size(mesh, axis: str) -> int:
    """The size of a named mesh axis: a ``Mesh``'s own, else the length of
    the device sequence for ``"data"`` (1 for any other name)."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return shape.get(axis, 1)
    return len(_devices(mesh)) if axis == "data" else 1


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension: ("pod", "data") on a mesh
    with a pod axis, else ("data",) (a device sequence's one axis)."""
    return ("pod", "data") if "pod" in getattr(mesh, "axis_names", MESH_AXES) else ("data",)


def batch_spec(mesh, batch_size: int) -> tuple:
    """Shard batch if divisible by the batch axes; else replicate (B=1)."""
    ax = batch_axes(mesh)
    total = 1
    for a in ax:
        total *= _axis_size(mesh, a)
    return _spec(ax) if batch_size % total == 0 else _spec(None)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: its device and the reference's spec for it."""

    device: torch.device
    spec: tuple = ()


def home_device(mesh) -> torch.device:
    """The device the port runs a model on: the mesh's first."""
    return _devices(mesh)[0]


def params_shardings(axes_tree, mesh):
    """``{key: Placement}`` (or the axes tree's own nesting) of the params'
    specs on the mesh's home device."""
    dev = home_device(mesh)
    return _map_axes(lambda a: Placement(dev, spec_for(a)), axes_tree)


def compute_spec(axes: tuple) -> tuple:
    """Weight layout *during compute*: storage spec minus the data (FSDP)
    axis."""

    def one(a):
        r = LOGICAL_RULES.get(a, None)
        return None if r == "data" else r

    return _spec(*(one(a) for a in axes))


def compute_specs_tree(axes_tree, drop_leading: int = 0):
    """drop_leading: strip stacked dims (e.g. the (L, ...) 'layers' axis)
    when the specs will be applied to per-layer slices."""
    return _map_axes(lambda a: compute_spec(a[drop_leading:]), axes_tree)


def params_pspecs(axes_tree):
    return _map_axes(spec_for, axes_tree)


def zero_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """Additionally shard optimizer state over the data axis (ZeRO-style).

    Picks the first unsharded dim divisible by the data axis; leaves the
    param's own (model) sharding intact.
    """
    data = _axis_size(mesh, "data")
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(p == "data" or (isinstance(p, tuple) and "data" in p) for p in parts):
        return _spec(*parts)  # already FSDP-sharded over data
    for i, (p, n) in enumerate(zip(parts, shape)):
        if p is None and n % data == 0 and n >= data:
            parts[i] = "data"
            return _spec(*parts)
    return _spec(*parts)


def zero_shardings(axes, abstract_params, mesh) -> dict:
    """Optimizer-state placements: ``axes`` the port's flat ``{state_dict
    key: logical axes}`` (``model.param_axes``), ``abstract_params`` a
    model (or a dict of tensors) with those keys, for the shapes.  A layer
    key carries one layer's axes and shape, so the ZeRO dim is chosen
    among the layer's own dims."""
    shapes = (abstract_params.state_dict() if hasattr(abstract_params, "state_dict")
              else abstract_params)
    dev = home_device(mesh)
    return {k: Placement(dev, zero_spec(spec_for(a), tuple(shapes[k].shape), mesh))
            for k, a in axes.items()}


def activation_spec(mesh, batch_size: int) -> tuple:
    """(B, T, d) activations: batch sharded, T/d replicated."""
    return batch_spec(mesh, batch_size)


# --------------------------------------------------------------------------
# Activation-sharding context, kept for the reference's callers: the batch
# axes, the data-shard count (the MoE's per-shard dispatch reads it) and
# the sequence-parallel flag.

_BATCH_AXES: tuple = ("data",)
_SEQ_PARALLEL = False  # shard T of the residual stream on "model"
_DATA_SHARDS = 1  # batch-axes size (for per-shard MoE dispatch)


def set_activation_batch_axes(axes: tuple, data_shards: int = None):
    global _BATCH_AXES, _DATA_SHARDS
    _BATCH_AXES = tuple(axes)
    if data_shards is not None:
        _DATA_SHARDS = int(data_shards)


def data_shard_count() -> int:
    return _DATA_SHARDS


def activation_batch_axes() -> tuple:
    return _BATCH_AXES


def set_seq_parallel(enabled: bool):
    """Megatron-style sequence parallelism on the residual stream (a flag
    for the reference's step builders; the port has no model axis)."""
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = bool(enabled)


def seq_parallel_enabled() -> bool:
    return _SEQ_PARALLEL


def constrain_batch(x, *rest):
    """Pin dim0 of ``x`` to the batch axes: the identity in the port, which
    has no model-parallel mesh (the reference's is a no-op without one)."""
    del rest
    return x
