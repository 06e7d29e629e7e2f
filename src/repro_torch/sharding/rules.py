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
"""

from __future__ import annotations

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


def _mesh_size(mesh) -> int:
    from repro_torch.sharding.batch import mesh_devices

    return len(mesh_devices(mesh))


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension: the reference's rule gives
    ("pod", "data") on a mesh with a pod axis, else ("data",), and every
    port mesh has the one axis "data"."""
    del mesh
    return ("data",)


def batch_spec(mesh, batch_size: int) -> tuple:
    """Shard batch if divisible by the batch axes; else replicate (B=1)."""
    return _spec(batch_axes(mesh)) if batch_size % _mesh_size(mesh) == 0 else _spec(None)


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
    data = _mesh_size(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(p == "data" or (isinstance(p, tuple) and "data" in p) for p in parts):
        return _spec(*parts)  # already FSDP-sharded over data
    for i, (p, n) in enumerate(zip(parts, shape)):
        if p is None and n % data == 0 and n >= data:
            parts[i] = "data"
            return _spec(*parts)
    return _spec(*parts)


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
