"""Multi-device batch compression (the PyTorch port).

GPULZ's design scales by making every chunk independent (paper §IV).  The
same independence holds one level up: whole buffers in a batch are
independent too, so the batched entry points (``pipeline.compress_many_chunks``
/ ``decompress_many_chunks``) can split the B dimension over a mesh and run
the registered single-device pipeline per shard.

The port's mesh is a sequence of devices (``torch.device`` or their names)
on one batch axis, ``"data"``.  ``ShardedBatchRunner`` is the layer:

  * B is padded with zero rows up to a multiple of the shard count and
    split into equal, contiguous shards, one a device of the mesh; the
    padded rows are dropped after the gather;
  * every shard runs the *unsharded* dispatch (``unsharded(cfg)``) on its
    own device, so ``"auto"`` resolves there (``fused-mono`` on a card,
    the plain entries on the CPU) and each row's container and symbols
    are byte-identical to the single-device dispatch;
  * results gather back to the device of the caller's tensors, in the
    reference's ``((B, cap) blobs, B totals)`` and ``(B, nc, C)`` forms.

Shards run one after another in the caller's thread (shards on the same
device could not overlap anyway); a shard never moves to a device the mesh
does not name.  A batch of ``deflate-full`` or ``lossy-fz`` containers
decodes container by container (``lzss.decompress_many``), its rows split
over the mesh by ``map_rows`` without padding (a zero row is no
container).  ``mesh=None`` is the plain batched dispatch.  The runner is reached
through the registry: ``LZSSConfig(backend="sharded", mesh=...)`` and
``lzss.decompress_many(..., mesh=...)`` select the ``"sharded"`` pair
(``pipeline.ShardedCompressor`` / ``ShardedDecoder``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pipeline
from repro_torch.sharding import rules


def mesh_devices(mesh) -> tuple:
    """The devices of a port mesh, as a tuple of ``torch.device``."""
    if isinstance(mesh, (str, torch.device)):
        mesh = (mesh,)
    try:
        devs = tuple(torch.device(d) for d in mesh)
    except (TypeError, RuntimeError) as e:
        raise ValueError(
            f"mesh=... takes a sequence of torch devices or their names "
            f"(a jax Mesh does not cross), got {mesh!r}"
        ) from e
    if not devs:
        raise ValueError("mesh=... needs at least one device")
    bad = [str(d) for d in devs if d.type not in ("cuda", "cpu")]
    if bad:
        raise ValueError(f"repro_torch runs on cuda or cpu, not {bad}")
    return devs


def unsharded(cfg: "pipeline.LZSSConfig") -> "pipeline.LZSSConfig":
    """The per-shard (single-device) view of a sharded config.

    Strips ``mesh`` / ``batch_axis`` and turns the ``"sharded"`` registry
    keys into ``"auto"``, which each shard resolves on its own device, so
    the function a shard runs is exactly the unsharded dispatch.
    """
    backend = "auto" if cfg.backend == "sharded" else cfg.backend
    decoder = "auto" if cfg.decoder == "sharded" else cfg.decoder
    if (backend, decoder, cfg.mesh) == (cfg.backend, cfg.decoder, None):
        return cfg
    return dataclasses.replace(
        cfg, backend=backend, decoder=decoder, mesh=None, batch_axis=None
    )


def normalize_batch_axes(mesh, batch_axis=None) -> tuple:
    """Mesh axes carrying the batch dimension, as a tuple of axis names.

    ``batch_axis`` may be a single axis name, a tuple of names, or ``None``
    (the logical batch axes of ``rules.batch_axes`` this mesh has; else its
    leading axis).
    """
    names = rules.MESH_AXES
    if batch_axis is None:
        axes = tuple(a for a in rules.batch_axes(mesh) if a in names)
        return axes or (names[0],)
    if isinstance(batch_axis, str):
        batch_axis = (batch_axis,)
    axes = tuple(batch_axis)
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"batch_axis {missing} not in mesh axes {names}")
    return axes


def _rows(x, lo: int, hi: int, device):
    """Rows ``lo:hi`` of a tensor (moved to ``device``) or of a list."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi].to(device)
    return list(x[lo:hi])


def _gather(outs: list, device):
    """Concatenate per-shard outputs along dim 0 on ``device``: tensors
    are concatenated, lists joined, tuples element by element."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_gather([o[i] for o in outs], device) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        if len(outs) == 1:
            return first.to(device)
        return torch.cat([o.to(device) for o in outs])
    return [v for o in outs for v in o]


def _sharded_call(fn, mesh: tuple, args: tuple):
    """``fn`` over dim 0 of every arg, split into contiguous shards, one a
    device of ``mesh``, each shard's rows on its device; the outputs
    gather on the device of the first tensor argument.  A shard that
    would hold no row is not run."""
    home = next(a.device for a in args if isinstance(a, torch.Tensor))
    rows = len(args[0])
    per = -(-rows // len(mesh))
    outs = []
    for i, dev in enumerate(mesh):
        lo, hi = i * per, min(rows, (i + 1) * per)
        if lo >= hi:
            break
        outs.append(fn(*(_rows(a, lo, hi, dev) for a in args)))
    return _gather(outs, home)


def _stack(outs: list):
    """Per-row outputs -> one batched output (tensors stacked, tuples
    element by element, anything else as a list)."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack([o[i] for o in outs]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return list(outs)


def shard_vmap(fn, mesh, axis):
    """Map ``fn`` over dim 0, with the rows split over the mesh's shards.

    The counterpart of the reference's ``shard_vmap`` (a ``jax.vmap`` under
    ``shard_map``): each shard of the named axis maps ``fn`` over its
    local rows, one row at a time, on its device; rows are zero-padded to a
    multiple of the shard count and the padding dropped after the gather.
    """
    devs = mesh_devices(mesh)
    normalize_batch_axes(devs, axis)

    def per_shard(*args):
        return _stack([fn(*(a[r] for a in args)) for r in range(len(args[0]))])

    def call(*args):
        b = len(args[0])
        bp = -(-b // len(devs)) * len(devs)
        out = _sharded_call(per_shard, devs, tuple(_pad_rows(a, bp) for a in args))
        return _take(out, b)

    return call


def _pad_rows(x, rows: int):
    """Zero-pad dim 0 up to ``rows``; padded outputs are sliced off after
    the gather.

    Zero rows are valid inputs of the raw pipeline on both sides: all-zero
    symbols compress, and a zero container row with zero tables decodes
    as zero tokens (every section gather is bounds-checked).  Host lists
    (``orig_bytes``) pad with zeros too.
    """
    pad = rows - len(x)
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return list(x) + [0] * pad


def _take(out, b: int):
    """The first ``b`` rows of a gathered output."""
    if isinstance(out, tuple):
        return tuple(_take(o, b) for o in out)
    return out[:b]


class ShardedBatchRunner:
    """Split the B dimension of the batched cores over a mesh.

    ``mesh=None`` is the plain batched dispatch on the caller's device.
    Otherwise B is padded to a multiple of the shard count and each shard
    runs the unsharded batched core on its device (see module docstring).
    """

    def __init__(self, mesh, batch_axis=None):
        self.mesh = None if mesh is None else mesh_devices(mesh)
        self.axes = None if mesh is None else normalize_batch_axes(self.mesh, batch_axis)

    @property
    def n_shards(self) -> int:
        return 1 if self.mesh is None else len(self.mesh)

    def _padded_rows(self, b: int) -> int:
        k = self.n_shards
        return -(-b // k) * k

    def compress_many(self, symbols, cfg, orig_bytes):
        """(B, nc, C) symbols -> ((B, cap) uint8 blobs, list of B totals).

        Every shard compresses its rows with ``unsharded(cfg)``, so each
        row's container is byte-identical to the single-device
        ``compress_many_chunks`` output.
        """
        inner = unsharded(cfg)
        if self.mesh is None:
            return pipeline.compress_many_chunks(symbols, inner, orig_bytes)
        b = symbols.shape[0]
        bp = self._padded_rows(b)
        out = _sharded_call(
            lambda s_, o_: pipeline.compress_many_chunks(s_, inner, o_),
            self.mesh,
            (_pad_rows(symbols, bp), _pad_rows(list(orig_bytes), bp)),
        )
        return _take(out, b)

    def decompress_many(self, blobs, n_tokens, payload_sizes, *, symbol_size,
                        chunk_symbols, n_chunks, decoder="auto"):
        """(B, L) blobs + (B, nc) tables -> (B, nc, C) symbols, sharded."""
        dec = "auto" if decoder == "sharded" else decoder
        kw = dict(symbol_size=symbol_size, chunk_symbols=chunk_symbols, n_chunks=n_chunks,
                  decoder=dec)
        if self.mesh is None:
            return pipeline.decompress_many_chunks(blobs, n_tokens, payload_sizes, **kw)
        b = blobs.shape[0]
        bp = self._padded_rows(b)
        out = _sharded_call(
            lambda b_, t_, p_: pipeline.decompress_many_chunks(b_, t_, p_, **kw),
            self.mesh,
            tuple(_pad_rows(x, bp) for x in (blobs, n_tokens, payload_sizes)),
        )
        return out[:b]

    def map_rows(self, fn, rows: list, device) -> list:
        """``fn(row, device)`` for each row, in order: the rows split into
        the same contiguous shards as the batched cores, unpadded, each
        run on its shard's device (``mesh=None``: all on ``device``)."""
        if self.mesh is None:
            return [fn(r, device) for r in rows]
        per = -(-len(rows) // self.n_shards)
        return [fn(r, self.mesh[i // per]) for i, r in enumerate(rows)]
