"""GPULZ host API in PyTorch: compress / decompress, single and batched.

    matching -> local prefix sum -> encoding -> global prefix sum -> deflating
    `------------- Kernel I -------------'    `-- Kernel II --'   `Kernel III'

The entry points run on the card: ``device=None`` means ``"cuda"``, and
without a card they raise rather than carry on on the CPU.  The CPU runs
only when the caller asks for it with ``device="cpu"``.  Containers are
format v2 — method 0 (raw LZSS), 1 (``deflate-full``) or 2 (``lossy-fz``)
— byte-identical to the reference package's, and the two packages read
each other's.  ``decompress`` routes on the container's method byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core.pipeline import (  # noqa: F401
    DEFAULT_CONFIG,
    WINDOW_LEVELS,
    CompressorBackend,
    DecoderBackend,
    LZSSConfig,
    available_backends,
    available_decoders,
    compress_chunks,
    compress_many_chunks,
    config_from_jax,
    container_method,
    decompress_chunks,
    decompress_many_chunks,
    default_backend,
    default_decoder,
    get_backend,
    get_decoder,
    pack_symbols,
    register_backend,
    register_decoder,
    resolve_backend,
    resolve_decoder,
    tuned_config,
    unpack_symbols,
)
from repro_torch.runtime import trace


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class CompressResult:
    data: np.ndarray        # uint8, exactly total_bytes long
    orig_bytes: int
    total_bytes: int

    @property
    def ratio(self) -> float:
        return self.orig_bytes / max(1, self.total_bytes)


@dataclasses.dataclass(frozen=True)
class BatchedCompressResult:
    """B containers compressed in one dispatch.

    ``data`` is the stacked (B, cap) uint8 buffer; row ``b`` holds a complete
    container in its first ``total_bytes[b]`` bytes (zeros beyond).
    """

    data: np.ndarray          # (B, cap) uint8
    orig_bytes: np.ndarray    # (B,) int64
    total_bytes: np.ndarray   # (B,) int64
    config: LZSSConfig

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, b: int) -> CompressResult:
        return CompressResult(
            data=self.data[b, : self.total_bytes[b]],
            orig_bytes=int(self.orig_bytes[b]),
            total_bytes=int(self.total_bytes[b]),
        )

    @property
    def ratio(self) -> float:
        return int(self.orig_bytes.sum()) / max(1, int(self.total_bytes.sum()))


def _host_bytes(data) -> np.ndarray:
    """Any host array or bytes -> its flat uint8 view (a copy only where the
    array is not contiguous)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def _as_bytes(data, device: torch.device) -> torch.Tensor:
    """Any array, tensor or bytes -> flat uint8 tensor on ``device``.

    Arrays and bytes are host memory and a CPU tensor is host memory for a
    CUDA ``device``: moving them is one blocking host-to-device copy."""
    if isinstance(data, torch.Tensor):
        t = data.detach().contiguous().reshape(-1).view(torch.uint8)
        host = t.device.type == "cpu" and device.type != "cpu"
    else:
        arr = _host_bytes(data)
        if not arr.flags.writeable:
            arr = arr.copy()
            trace.count("bytes_host_copy", arr.nbytes)
        t = torch.from_numpy(arr)
        host = True
    if host:
        trace.count("bytes_h2d", t.numel())
        trace.count("host_syncs", 1)
    return t.to(device)


def _gather(arrays, device: torch.device):
    """A batch of buffers -> (their bytes end to end, one flat uint8 tensor
    on ``device``; the list of their B byte sizes).

    A (B, n) array or tensor is B rows of one buffer.  Tensors of one dtype
    on one device are joined by one ``torch.cat``, host arrays and bytes by
    one ``np.concatenate`` and moved in one copy; a list that mixes the two,
    dtypes or devices takes ``_as_bytes`` a buffer."""
    if isinstance(arrays, (np.ndarray, torch.Tensor)) and arrays.ndim == 2:
        b = arrays.shape[0]
        if b == 0:
            raise ValueError("compress_many needs at least one buffer")
        flat = _as_bytes(arrays, device)
        return flat, [flat.numel() // b] * b
    arrays = list(arrays)
    if not arrays:
        raise ValueError("compress_many needs at least one buffer")
    head = arrays[0]
    if isinstance(head, torch.Tensor):
        dtype, index = head.dtype, head.get_device()
        if all(isinstance(a, torch.Tensor) and a.dtype == dtype and a.get_device() == index
               for a in arrays):
            sizes = [a.nbytes for a in arrays]  # numel() * element_size()
            if len(arrays) > 1:
                with torch.no_grad():
                    head = torch.cat([a if a.dim() == 1 else a.reshape(-1) for a in arrays])
            return _as_bytes(head, device), sizes
    if not any(isinstance(a, torch.Tensor) for a in arrays):
        parts = [_host_bytes(a) for a in arrays]
        if len(parts) > 1:
            joined = np.concatenate(parts)
            trace.count("bytes_host_copy", joined.nbytes)
        else:
            joined = parts[0]
        return _as_bytes(joined, device), [p.size for p in parts]
    raws = [_as_bytes(a, device) for a in arrays]
    return torch.cat(raws), [r.numel() for r in raws]


def _to_host(t: torch.Tensor, pinned: bool = False) -> np.ndarray:
    """A device result -> numpy: one blocking device-to-host copy, into a
    fresh pageable buffer or, with ``pinned``, into a block of
    ``format.pinned_block`` (``t`` is then uint8).  The returned array then
    holds its block, which goes back to torch's host cache when the array is
    dropped."""
    trace.count("bytes_d2h", t.numel() * t.element_size())
    trace.count("host_syncs", 1)
    if not pinned:
        return t.cpu().numpy()
    host = fmt.pinned_block(t.shape)
    host.copy_(t)
    return host.numpy()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array -> tensor on ``device``: one blocking host-to-device copy."""
    trace.count("bytes_h2d", a.nbytes)
    trace.count("host_syncs", 1)
    return torch.from_numpy(a).to(device)


# a symbol of S bytes as one element, which a copy to int32 widens with its
# bits kept (zero-extended below S = 4)
_WIDE = {1: torch.uint8, 2: torch.uint16, 4: torch.int32}


def _fill_rows(rows: torch.Tensor, src: torch.Tensor, lengths) -> None:
    """Copy the B buffers that lie end to end in the flat ``src``,
    ``lengths[i]`` elements each, into the B rows of ``rows`` (converted to
    its dtype), and zero the rest of every row.

    A batch whose buffers but the last fill their rows is one copy; one
    whose buffers but the last share a length, the last no longer, is a
    copy of those rows and one of the last.  Any other is copied a buffer at
    a time, counted under ``rows_packed_alone``."""
    b, width = rows.shape
    head = lengths[0]
    if all(n == width for n in lengths[:-1]):
        flat = rows.view(-1)
        flat[: src.numel()].copy_(src)
        flat[src.numel() :].zero_()
    elif all(n == head for n in lengths[:-1]) and lengths[-1] <= head:
        even = b if lengths[-1] == head else b - 1
        rows[:even, :head].copy_(src[: even * head].view(even, head))
        rows[:, head:].zero_()
        if even < b:
            rows[-1, : lengths[-1]].copy_(src[even * head :])
            rows[-1, lengths[-1] : head].zero_()
    else:
        trace.count("rows_packed_alone", b)
        rows.zero_()
        start = 0
        for i, n in enumerate(lengths):
            rows[i, :n].copy_(src[start : start + n])
            start += n


def _pack(flat: torch.Tensor, sizes, cfg: LZSSConfig) -> torch.Tensor:
    """B buffers' bytes end to end in ``flat`` -> (B, nc, C) int32 symbols,
    every buffer zero-padded to the batch's common chunk count.

    Where every buffer holds whole symbols the copy into the rows widens
    each symbol itself; otherwise the bytes are padded first and then packed
    as ``pack_symbols`` packs them."""
    s, c = cfg.symbol_size, cfg.chunk_symbols
    b = len(sizes)
    nc = _n_chunks(max(sizes), cfg)
    if flat.data_ptr() % s == 0 and all(n % s == 0 for n in sizes):
        rows = torch.empty(b, nc * c, dtype=torch.int32, device=flat.device)
        _fill_rows(rows, flat.view(_WIDE[s]), [n // s for n in sizes])
    else:
        padded = torch.empty(b, nc * c * s, dtype=torch.uint8, device=flat.device)
        _fill_rows(padded, flat, sizes)
        rows = pack_symbols(padded.view(-1), s)
    trace.count("symbol_bytes", rows.numel() * rows.element_size())
    return rows.view(b, nc, c)


def _n_chunks(n_bytes: int, cfg: LZSSConfig) -> int:
    nsym = -(-max(n_bytes, 1) // cfg.symbol_size)
    return -(-nsym // cfg.chunk_symbols)


def compress(data, config: LZSSConfig = DEFAULT_CONFIG, device=None) -> CompressResult:
    """Compress any array/bytes. Pads to whole chunks; header records truth.

    On a CUDA device the container comes back into page-locked host memory
    from torch's caching host allocator, reused across calls.  The returned
    ``data`` holds its block, which goes back to that cache when the array
    is dropped; a caller who keeps many results can take a pageable copy
    with ``np.array(res.data)``.
    """
    dev = resolve_device(device)
    with trace.span("lzss.compress") as root:
        with trace.span("lzss.h2d", dev):
            raw = _as_bytes(data, dev)
        n = raw.numel()
        with trace.span("lzss.pack"):
            symbols = _pack(raw, [n], config)
        with trace.span("lzss.dispatch"):
            blobs, totals = compress_many_chunks(symbols, config, [n])
            buf, total = blobs[0], totals[0]
        root.set(bytes=n, method=container_method(config.backend))
        with trace.span("lzss.d2h", dev):
            host = _to_host(buf[:total], dev.type == "cuda")
    return CompressResult(data=host, orig_bytes=n, total_bytes=total)


def _validated(blob, pinned: bool = False):
    """Host-side validation of one container -> (uint8 array, header, tables).

    The container is first copied once in host memory, writable for
    ``torch.from_numpy``: into a fresh array, or with ``pinned`` into a
    block of ``format.pinned_block``, from which its copy to the card needs
    no staging."""
    if isinstance(blob, torch.Tensor):
        blob = blob.detach()
        blob = _to_host(blob) if blob.device.type != "cpu" else blob.numpy()
    elif isinstance(blob, (bytes, bytearray, memoryview)):
        blob = np.frombuffer(blob, np.uint8)
    if pinned:
        src = np.asarray(blob, np.uint8)
        blob = fmt.pinned_block(src.shape).numpy()
        np.copyto(blob, src)
    else:
        blob = np.array(blob, np.uint8)  # a writable copy for torch.from_numpy
    trace.count("bytes_host_copy", blob.nbytes)
    h, n_tokens, payload_sizes = fmt.validate_container(blob)
    return blob, h, n_tokens, payload_sizes


def _route(method: int, decoder: str, dev, *, batch: bool = False) -> str:
    """The decoder key for containers of ``method``: entropy containers
    decode only through the entropy decoder, lossy ones only through the
    lossy decoder, raw ones through any raw decoder.  A mismatch is a
    ``ValueError`` (the reference's messages), never garbage symbols."""
    what, verb, this = (
        ("containers", "decode", "this batch") if batch
        else ("container", "decodes", "this container")
    )
    if method == fmt.METHOD_HUFFMAN:
        if decoder not in ("auto", "deflate-full"):
            raise ValueError(
                f"method-1 (entropy) {what}: {verb} only via "
                f"decoder='deflate-full' (or 'auto'), got {decoder!r}"
            )
        return "deflate-full"
    if method == fmt.METHOD_LOSSY:
        if decoder not in ("auto", "lossy-fz"):
            raise ValueError(
                f"method byte {method} (lossy) {what}: {verb} only "
                f"via decoder='lossy-fz' (or 'auto'), got {decoder!r}"
            )
        return "lossy-fz"
    dec = resolve_decoder(decoder, dev)
    if dec == "deflate-full":
        raise ValueError(
            "decoder='deflate-full' decodes method-1 (entropy) "
            f"containers only; {this} is method 0 (raw LZSS)"
        )
    if dec == "lossy-fz":
        raise ValueError(
            "decoder='lossy-fz' decodes method-2 (lossy) containers "
            f"only; {this}'s method byte is {method}"
        )
    return dec


def decompress(blob, decoder: str = "auto", device=None, chunks_per_block=None) -> np.ndarray:
    """Decompress a container -> uint8 array of the original bytes.

    Raises ``ValueError`` on a truncated or corrupt container (the checks of
    ``format.validate_container``) before anything is decoded, and on a
    decoder that does not read the container's method.
    ``chunks_per_block`` is accepted for the reference's signature and has
    no effect on the Hopper kernels.

    On a CUDA device the container's host copy and the result live in
    page-locked host memory from torch's caching host allocator, reused
    across calls.  The returned array holds its block, which goes back to
    that cache when the array is dropped; a caller who keeps many results
    can take a pageable copy with ``np.array(out)``.
    """
    dev = resolve_device(device)
    pinned = dev.type == "cuda"
    with trace.span("lzss.decompress") as root:
        with trace.span("lzss.validate"):
            blob, h, n_tokens, payload_sizes = _validated(blob, pinned)
        root.set(bytes=h.orig_bytes, method=h.method)
        dec = _route(h.method, decoder, dev)
        whole = getattr(get_decoder(dec, dev), "decode_blob", None)
        # the container, and for the section decoders its A/B tables
        host = [blob] if whole is not None else [blob, n_tokens, payload_sizes]
        with trace.span("lzss.h2d", dev):
            moved = [_to_device(a, dev) for a in host]
        with trace.span("lzss.decode"):
            if whole is not None:
                symbols = whole(moved[0], h)
            else:
                symbols = decompress_chunks(
                    *moved,
                    symbol_size=h.symbol_size,
                    chunk_symbols=h.chunk_symbols,
                    n_chunks=h.n_chunks,
                    decoder=dec,
                )
        with trace.span("lzss.unpack"):
            out = unpack_symbols(symbols.reshape(-1), h.symbol_size)[: h.orig_bytes]
        with trace.span("lzss.d2h", dev):
            return _to_host(out, pinned)


def compression_ratio(data, config: LZSSConfig = DEFAULT_CONFIG, device=None) -> float:
    return compress(data, config, device).ratio


def compress_many(arrays, config: LZSSConfig = DEFAULT_CONFIG, device=None) -> BatchedCompressResult:
    """Compress a batch of buffers in one dispatch.

    ``arrays`` is a list of array-likes or tensors (ragged sizes allowed —
    every buffer is padded to the batch's common chunk count, headers record
    true sizes) or a (B, n) array treated as B equal-size buffers.  The
    batch is gathered, packed and given its headers once, not a buffer at a
    time (``_gather``, ``_pack``).

    On a CUDA device the (B, cap) buffer comes back into page-locked host
    memory, as ``compress``'s container does: ``data``, and every row taken
    from it, holds that block until all of them are dropped;
    ``np.array(batch.data)`` gives a pageable copy.
    """
    dev = resolve_device(device)
    with trace.span("lzss.compress_many") as root:
        with trace.span("lzss.h2d", dev):
            flat, sizes = _gather(arrays, dev)
        with trace.span("lzss.pack"):
            symbols = _pack(flat, sizes, config)
        with trace.span("lzss.dispatch"):
            data, totals = compress_many_chunks(symbols, config, sizes)
        root.set(bytes=sum(sizes), method=container_method(config.backend), buffers=len(sizes))
        with trace.span("lzss.d2h", dev):
            host = _to_host(data, dev.type == "cuda")
    return BatchedCompressResult(
        data=host,
        orig_bytes=np.asarray(sizes, np.int64),
        total_bytes=np.asarray(totals, np.int64),
        config=config,
    )


def decompress_many(batch, decoder: str = "auto", device=None, mesh=None, batch_axis=None,
                    chunks_per_block=None) -> list:
    """Decompress a batch of containers in one dispatch.

    ``batch`` is a ``BatchedCompressResult`` or a list of container blobs,
    all of one geometry (S, C, n_chunks, method) — true for anything
    produced by ``compress_many``; a lossy batch also shares its (mode,
    inner method).  Raw batches decode in one decoder launch; entropy and
    lossy batches container by container.  ``mesh`` / ``batch_axis`` split
    the batch over a sequence of devices through the ``"sharded"`` decoder
    (sharding/batch.py), each shard decoding with its device's default; an
    entropy or lossy batch decodes container by container, each on its
    shard's device.  The bytes are those of the unsharded dispatch.
    ``chunks_per_block`` is accepted for the reference's signature and has
    no effect on the Hopper kernels.  Returns a list of uint8 arrays.
    """
    if mesh is None and batch_axis is not None:
        raise ValueError("batch_axis requires mesh=...")
    dev = resolve_device(device)
    if isinstance(batch, BatchedCompressResult):
        blobs = [batch.data[b, : int(batch.total_bytes[b])] for b in range(len(batch))]
    else:
        blobs = list(batch)
    if not blobs:
        raise ValueError("decompress_many needs at least one container")
    with trace.span("lzss.decompress_many") as root:
        checked = []
        with trace.span("lzss.validate"):
            for i, b in enumerate(blobs):
                try:
                    checked.append(_validated(b))
                except ValueError as e:
                    raise ValueError(f"buffer {i}: {e}") from None
        h0 = checked[0][1]
        root.set(bytes=sum(c[1].orig_bytes for c in checked), method=h0.method,
                 buffers=len(checked))
        for i, (_, h, _, _) in enumerate(checked[1:], start=1):
            if (h.symbol_size, h.chunk_symbols, h.n_chunks, h.method) != (
                h0.symbol_size, h0.chunk_symbols, h0.n_chunks, h0.method
            ):
                raise ValueError(
                    f"decompress_many requires a homogeneous batch geometry; "
                    f"buffer 0 has (symbol_size={h0.symbol_size}, "
                    f"chunk_symbols={h0.chunk_symbols}, n_chunks={h0.n_chunks}, "
                    f"method={h0.method}) "
                    f"but buffer {i} has (symbol_size={h.symbol_size}, "
                    f"chunk_symbols={h.chunk_symbols}, n_chunks={h.n_chunks}, "
                    f"method={h.method}); "
                    f"decompress mismatched containers individually"
                )
        if h0.method == fmt.METHOD_LOSSY:
            sp = get_decoder("lossy-fz", dev).static_params
            for i, (_, h, _, _) in enumerate(checked[1:], start=1):
                if sp(h) != sp(h0):
                    raise ValueError(
                        f"decompress_many requires a homogeneous lossy batch; "
                        f"buffer 0 has (mode, inner_method)={sp(h0)} "
                        f"but buffer {i} has {sp(h)}; "
                        f"decompress mismatched containers individually"
                    )
        if mesh is not None and decoder not in ("auto", "sharded"):
            raise ValueError(
                f"mesh= shards the dispatch through the 'sharded' decoder; "
                f"it cannot be combined with decoder={decoder!r}"
            )
        dec = _route(h0.method, "auto" if mesh is not None else decoder, dev, batch=True)
        whole = getattr(get_decoder(dec, dev), "decode_blob", None)
        if whole is not None:
            # container by container; with a mesh, each row on its shard's device
            from repro_torch.sharding import batch as shbatch  # lazy: avoid a cycle

            def one(row, d):
                b, h, _, _ = row
                with trace.span("lzss.h2d", d):
                    moved = _to_device(b, d)
                with trace.span("lzss.decode"):
                    sym = whole(moved, h).reshape(-1)
                with trace.span("lzss.unpack"):
                    out = unpack_symbols(sym, h.symbol_size)[: h.orig_bytes]
                with trace.span("lzss.d2h", d):
                    return _to_host(out)

            return shbatch.ShardedBatchRunner(mesh, batch_axis).map_rows(one, checked, dev)
        if mesh is not None:
            dec = "sharded"
        with trace.span("lzss.h2d", dev):
            width = max(c[0].size for c in checked)
            stacked = np.zeros((len(checked), width), np.uint8)
            for i, c in enumerate(checked):
                stacked[i, : c[0].size] = c[0]
            trace.count("bytes_host_copy", sum(c[0].size for c in checked))
            moved = [_to_device(a, dev) for a in (
                stacked, np.stack([c[2] for c in checked]), np.stack([c[3] for c in checked]))]
        with trace.span("lzss.decode"):
            symbols = decompress_many_chunks(
                *moved,
                symbol_size=h0.symbol_size,
                chunk_symbols=h0.chunk_symbols,
                n_chunks=h0.n_chunks,
                decoder=dec,
                mesh=mesh,
                batch_axis=batch_axis,
            )
        s = h0.symbol_size
        out = []
        for i, (_, h, _, _) in enumerate(checked):
            with trace.span("lzss.unpack"):
                row = unpack_symbols(symbols[i].reshape(-1), s)[: h.orig_bytes]
            with trace.span("lzss.d2h", dev):
                out.append(_to_host(row))
        return out
