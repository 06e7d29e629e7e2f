"""KV-cache block manager with GPULZ eviction compression.

The host-side block manager a serving deployment wraps around the decode
caches: fixed-size blocks, LRU eviction of cold blocks to host memory,
evicted blocks GPULZ-compressed (S=2 over bf16: the paper's multi-byte rule
for 2-byte data).

Eviction is batched: ``evict_many`` compresses every cold block of an
eviction round in ONE dispatch (``lzss.compress_many``: one launch of the
one-launch compressor on a card) instead of one ``compress()`` call per
block, and ``restore_many`` is the batched inverse (one
``lzss.decompress_many`` per geometry and method group).  Blocks may be
numpy arrays or tensors; a tensor on the card is compressed where it lies,
with no copy to the host first.  Stored blobs are host numpy bytes, the
reference store's bytes for the same blocks: freeing device memory is the
point of the tier.  A tensor block restores as a numpy array of its dtype
(bf16 as ``uint16`` bits, the convention of ``models/convert.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import format as fmt, lzss

# Geometry for KV blocks (S=2 over bf16).  backend/decoder stay "auto":
# resolved by device at dispatch (the one-launch fused-mono pair on a card).
KV_LZ = lzss.LZSSConfig(symbol_size=2, window=64, chunk_symbols=2048, backend="auto")

# torch dtypes a block may have -> the numpy dtype its bytes restore as
_NUMPY_OF = {torch.bfloat16: np.dtype(np.uint16)}


@dataclasses.dataclass
class BlockStats:
    evictions: int = 0
    restores: int = 0
    evicted_bytes_raw: int = 0
    evicted_bytes_stored: int = 0
    eviction_dispatches: int = 0    # compression calls issued
    restore_dispatches: int = 0     # decompression calls issued
                                    # (raw-codec blocks restore with zero)

    @property
    def eviction_ratio(self) -> float:
        return self.evicted_bytes_raw / max(1, self.evicted_bytes_stored)


def _meta(block) -> tuple:
    """(numpy dtype str, shape) a block restores as."""
    if isinstance(block, torch.Tensor):
        dt = _NUMPY_OF.get(block.dtype)
        if dt is None:
            dt = torch.empty((), dtype=block.dtype).numpy().dtype
        return dt.str, tuple(block.shape)
    return block.dtype.str, block.shape


def _flat_bytes(block):
    """A block's bytes, flat uint8: of a tensor where it lies, or of a
    contiguous numpy array."""
    if isinstance(block, torch.Tensor):
        return block.detach().contiguous().reshape(-1).view(torch.uint8)
    return block.view(np.uint8).reshape(-1)


class KVBlockStore:
    """Host-side store of evicted KV blocks, compressed with GPULZ.

    ``backend`` overrides the eviction-path compressor and ``decoder`` the
    restore-path decoder (registry keys; default ``"auto"``: the one-launch
    ``fused-mono`` pair on a card).  ``device`` is where blocks are
    compressed and decompressed (``None``: ``cuda``, raising without a
    card; ``"cpu"`` runs the plain path).

    ``mesh``/``batch_axis`` shard each round's batch dimension over a
    sequence of devices (``sharding/batch.py``): backend and decoder
    default to the ``"sharded"`` registry pair, and stored blobs stay
    byte-identical to the single-device dispatch.

    ``lossy_eb`` selects the error-bounded ``lossy-fz`` codec for evicted
    blocks (f32 blocks ONLY, rejected otherwise): each restored element is
    within ``eb`` of the evicted value (non-finite elements exact).  An
    explicit ``backend`` then names the codec's *inner* lossless stage.
    """

    def __init__(self, compress: bool = True, config=None, decoder=None, backend=None, mesh=None,
                 batch_axis=None, lossy_eb=None, device=None):
        self.compress = compress
        self.device = device
        if config is None:
            config = KV_LZ
        if mesh is None and batch_axis is not None:
            # as LZSSConfig: a silently ignored batch_axis would read as
            # "sharding configured" while dispatching single-device
            raise ValueError("batch_axis requires mesh=...")
        overrides = {}
        if backend is not None:
            overrides["backend"] = backend
        if decoder is not None:
            overrides["decoder"] = decoder
        if lossy_eb is not None:
            # the named backend becomes the inner lossless stage of the
            # lossy container (as optim/grad_compress.lossy_grad_config)
            inner = overrides.get("backend", "auto")
            overrides["lossy_inner"] = "auto" if inner in ("lossy-fz", "sharded") else inner
            overrides["backend"] = "lossy-fz"
            overrides["symbol_size"] = 4
            overrides["lossy_eb"] = float(lossy_eb)
        if mesh is not None:
            # a mesh implies the sharded registry pair unless this call
            # explicitly picked a different strategy ("auto" is not one)
            if overrides.get("backend", "auto") == "auto":
                overrides["backend"] = "sharded"
            if overrides.get("decoder", "auto") == "auto":
                overrides["decoder"] = "sharded"
            overrides["mesh"] = mesh
            overrides["batch_axis"] = batch_axis
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self._store: dict = {}
        self.stats = BlockStats()

    def evict_many(self, items) -> None:
        """Batch-evict ``[(key, block), ...]``: one compression dispatch.

        Blocks may be ragged (different shapes/sizes); the batched pipeline
        pads them to a common chunk count and every header records the true
        size.
        """
        items = list(items)
        if not items:
            return
        keys = [k for k, _ in items]
        blocks = [b if isinstance(b, torch.Tensor) else np.ascontiguousarray(b) for _, b in items]
        metas = [_meta(b) for b in blocks]
        if self.compress and self.config.backend == "lossy-fz":
            bad = [(k, str(np.dtype(m[0]))) for k, m in zip(keys, metas)
                   if np.dtype(m[0]) != np.float32]
            if bad:
                raise ValueError(
                    f"lossy_eb eviction codec (lossy-fz) bounds the error of "
                    f"float32 blocks only; got {bad} — evict these through a "
                    f"lossless store (lossy_eb=None)"
                )
        raws = [_flat_bytes(b) for b in blocks]
        if self.compress:
            batch = lzss.compress_many(raws, self.config, device=self.device)
            self.stats.eviction_dispatches += 1
            for i, (key, meta) in enumerate(zip(keys, metas)):
                res = batch[i]
                # copy: res.data is a view into the batch's (B, cap) buffer;
                # storing the view would pin the whole padded batch in memory
                self._store[key] = ("gpulz", meta, res.data.copy())
                self.stats.evicted_bytes_stored += res.total_bytes
        else:
            for key, meta, raw in zip(keys, metas, raws):
                raw = raw.cpu().numpy() if isinstance(raw, torch.Tensor) else raw
                self._store[key] = ("raw", meta, raw.tobytes())
                self.stats.evicted_bytes_stored += raw.nbytes
        self.stats.evictions += len(raws)
        self.stats.evicted_bytes_raw += sum(int(r.nbytes) for r in raws)

    def evict(self, key, block) -> None:
        self.evict_many([(key, block)])

    def _reassemble(self, meta, raw_bytes: np.ndarray) -> np.ndarray:
        dtype, shape = meta
        return raw_bytes.view(np.dtype(dtype)).reshape(shape)

    def restore_many(self, keys) -> list:
        """Batch-restore blocks: one decompression dispatch per geometry."""
        keys = list(keys)
        missing = [k for k in keys if k not in self._store]
        if missing:  # validate before mutating: a bad key must not lose data
            raise KeyError(f"blocks not in store: {missing}")
        popped = [self._store.pop(k) for k in keys]
        self.stats.restores += len(keys)
        out = [None] * len(keys)
        groups: dict = {}  # container geometry + codec id -> block indices
        for i, (codec, _, blob) in enumerate(popped):
            if codec == "gpulz":
                h = fmt.parse_header(blob)
                # version + method byte are part of the batching key: a
                # store holding raw, deflate-full and lossy blobs (codec
                # changed between rounds) must not land a mixed-method batch
                # in one decompress_many call; lossy blobs also split on
                # their (mode, inner method)
                key = (h.version, h.method, h.symbol_size, h.chunk_symbols, h.n_chunks,
                       h.lossy_mode, h.inner_method)
                groups.setdefault(key, []).append(i)
        # an explicitly non-sharded decoder + mesh means compress-side
        # sharding only: restore single-device rather than conflicting
        sharded = self.config.decoder in ("auto", "sharded")
        method_only = {fmt.METHOD_HUFFMAN: "deflate-full", fmt.METHOD_LOSSY: "lossy-fz"}
        for gkey, idxs in groups.items():
            decoder = self.config.decoder
            if decoder not in ("auto", "sharded") and decoder != method_only.get(gkey[1]) and (
                    decoder in method_only.values() or gkey[1] in method_only):
                # decoder/method mismatch (codec changed between eviction
                # rounds): fall back per group, the method byte routes
                decoder = "auto"
            raws = lzss.decompress_many(
                [popped[i][2] for i in idxs], decoder=decoder, device=self.device,
                mesh=self.config.mesh if sharded else None,
                batch_axis=self.config.batch_axis if sharded else None,
            )
            self.stats.restore_dispatches += 1
            for i, raw in zip(idxs, raws):
                out[i] = self._reassemble(popped[i][1], raw)
        for i, (codec, meta, payload) in enumerate(popped):
            if codec == "raw":
                out[i] = self._reassemble(meta, np.frombuffer(payload, np.uint8))
        return out

    def restore(self, key) -> np.ndarray:
        return self.restore_many([key])[0]

    def discard(self, key) -> None:
        """Drop a stored block without restoring it (stale generation)."""
        self._store.pop(key, None)

    def keys(self):
        return list(self._store.keys())

    def __contains__(self, key):
        return key in self._store

    def __len__(self):
        return len(self._store)


class PagedKVTracker:
    """Block-granular access tracking -> eviction candidates (LRU).

    Recency is a monotonic *logical* access counter, not a wall clock:
    eviction order is a pure function of the access sequence, so tests can
    pin candidate order and same-round ties break by touch order instead of
    timer resolution.
    """

    def __init__(self, block_tokens: int = 256, budget_blocks: int = 1024):
        self.block_tokens = block_tokens
        self.budget = budget_blocks
        self._last_access: dict = {}
        self._clock = 0

    def touch_block(self, key) -> None:
        """Mark one (opaque) block key as just-accessed."""
        self._clock += 1
        self._last_access[key] = self._clock

    def touch(self, seq_id: int, pos: int):
        self.touch_block((seq_id, pos // self.block_tokens))

    def eviction_candidates(self):
        if len(self._last_access) <= self.budget:
            return []
        n = len(self._last_access) - self.budget
        items = sorted(self._last_access.items(), key=lambda kv: kv[1])
        return [k for k, _ in items[:n]]

    def candidates(self, n: int, protected=()):
        """The n least-recently-used tracked keys outside ``protected``."""
        protected = set(protected)
        items = sorted(self._last_access.items(), key=lambda kv: kv[1])
        out = []
        for k, _ in items:
            if k in protected:
                continue
            out.append(k)
            if len(out) == n:
                break
        return out

    def drop(self, key):
        self._last_access.pop(key, None)
