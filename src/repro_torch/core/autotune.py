"""Architecture-adaptive chunk-geometry autotuner for the Hopper kernels.

GPULZ's third contribution is "maximizing shared memory utilization by
adapting data partitions to different GPU architectures" (PAPER.md §1).  On
Hopper the knob is ``chunk_symbols`` (C): every CUDA kernel of the port runs
one thread block per chunk with the chunk in shared memory, so C sets each
block's shared memory and with it how many blocks an SM holds.  This module
chooses C by a timed sweep, with the reference package's surface
(``repro/core/autotune.py``): ``TuneKey``, the JSON cache, its gating and
its trace guard.

Design:

  * ``TuneKey`` — one tuning problem: (device kind, dtype, S, W, direction,
    C).  ``direction`` is ``"compress"`` (the one-launch compressor,
    kernels/lz_fused.py) or ``"decompress"`` (the one-launch decoder,
    kernels/lz_decode_mono.py; its cost is W-independent, so decode keys
    carry ``window=0``).  ``chunk_symbols`` is the fixed container C or
    ``None`` for the joint sweep behind ``tuned_chunk_geometry`` /
    ``pipeline.tuned_config``.  ``cache_key()`` strings are the reference's,
    letter for letter.
  * ``best_geometry(key)`` — memo, then the JSON cache, then (if tuning is
    enabled) a timed sweep over ``candidates(key)``, persisted; otherwise
    the deterministic ``fallback``.
  * The cache is a JSON file at ``$REPRO_AUTOTUNE_CACHE`` (default
    ``~/.cache/gpulz-repro/autotune.json``), schema version 1 as in the
    reference, so either package reads the other's file.  A corrupted file
    is treated as empty and rewritten, never crashed on; writes go to a
    temporary file and ``os.replace``.

The Hopper adaptations of the reference:

  * **Budget.**  The reference's per-grid-step VMEM estimate against 16 MiB
    becomes ``kernel_smem_bytes`` + ``SMEM_STATIC_BYTES`` against
    ``SMEM_LIMIT_BYTES``, the shared memory one thread block may use.
    ``candidates`` filters by that fit and ``_entry_geometry`` re-checks a
    cached entry against it on every hit.
  * **The g axis.**  g is fixed at ``DEFAULT_CHUNKS_PER_BLOCK``: no Hopper
    kernel reads ``chunks_per_block`` (one thread block runs one chunk).
  * **Device kind.**  ``torch.cuda.get_device_name(0)`` with spaces as
    ``_`` (``NVIDIA_H100_80GB_HBM3``), or ``"cpu"`` without a card.
  * **Gating.**  ``REPRO_AUTOTUNE=1`` forces tuning on, ``0`` forces the
    deterministic fallback (C=2048, g=8).  Unset, tuning runs only when
    ``torch.cuda.is_available()``: CPU timings of the plain versions are as
    meaningless as the reference's interpret mode.
  * **Trace guard.**  ``trace_state_clean()`` is false while a CUDA graph is
    being captured or ``torch.compile`` is tracing; there the kernel calls
    would be recorded, not run, and a timing would be noise.  Under either,
    ``best_geometry`` serves the memo or the cache, or else the fallback,
    unmemoised and unpersisted, as the reference does under a jit trace.
  * **Workload.**  ``_default_measure`` times ``sweep_inputs``, a fixed
    byte count per candidate (``SWEEP_BYTES``, 32 MiB), with CUDA events
    around each call, not the reference's 16 chunks on the host clock:
    16 chunks are 16 thread blocks, which leave 116 of the H100's 132 SMs
    idle, and every C would time as one launch.  The symbols are the
    reference's seeded run-heavy corpus and its all-literal container, the
    same stream for every C of a sweep.
  * ``FALLBACK_TABLE`` stays empty: no TPU rows carry over.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

# The static geometry: every kernel's default and the deterministic fallback
# when tuning is disabled.
DEFAULT_CHUNK_SYMBOLS = 2048
DEFAULT_CHUNKS_PER_BLOCK = 8

# Shared memory one thread block may use on Hopper (sm_90: 227 KB).
SMEM_LIMIT_BYTES = 232_448
# Static shared memory of the kernels' block scans, beside the dynamic part.
SMEM_STATIC_BYTES = 1024

CACHE_VERSION = 1
CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
ENABLE_ENV = "REPRO_AUTOTUNE"

# Candidate grid: the reference's pow-2 C ladder, each C with the one g.
# Candidates over the shared-memory budget are filtered per key.
CHUNK_SYMBOL_CANDIDATES = (512, 1024, 2048, 4096)

# Bytes of input each candidate of a sweep is timed on.
SWEEP_BYTES = 32 << 20

# Deterministic per-architecture fallback rows: (device-kind prefix,
# direction) -> (chunk_symbols, chunks_per_block).  Empty: an absent row
# falls back to the static geometry.
FALLBACK_TABLE: Dict[Tuple[str, str], Tuple[int, int]] = {}

_MEMO: Dict[str, Tuple[int, int]] = {}  # per-process: cache_key -> (C, g)
_SWEEPS: Dict[str, int] = {}  # telemetry (tests assert on it): key -> sweeps


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """One tuning problem; hashable, stable string form via ``cache_key``."""

    device_kind: str
    dtype: str
    symbol_size: int
    window: int  # 0 on the decode side: decode cost is W-independent
    direction: str  # "compress" | "decompress"
    chunk_symbols: Optional[int]  # fixed C, or None for the joint sweep

    def cache_key(self) -> str:
        c = "auto" if self.chunk_symbols is None else str(self.chunk_symbols)
        return (
            f"{self.device_kind}|{self.dtype}|s{self.symbol_size}"
            f"|w{self.window}|{self.direction}|c{c}"
        )


def device_kind() -> str:
    """Normalized device kind (``NVIDIA_H100_80GB_HBM3``, ``cpu``)."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0).replace(" ", "_")


def default_dtype(symbol_size: int) -> str:
    return {1: "u8", 2: "u16", 4: "u32"}[symbol_size]


def enabled() -> bool:
    """Whether timed sweeps run (vs the deterministic fallback)."""
    flag = os.environ.get(ENABLE_ENV)
    if flag is not None:
        return flag != "0"
    return torch.cuda.is_available()  # CPU timings of plain versions are meaningless


def trace_state_clean() -> bool:
    """True unless a CUDA graph is being captured or torch.compile traces."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return False
    return not torch.compiler.is_compiling()


def cache_path() -> str:
    return os.environ.get(
        CACHE_ENV,
        os.path.join(
            os.path.expanduser("~"), ".cache", "gpulz-repro", "autotune.json"
        ),
    )


# ------------------------------------------------------------- validation


def kernel_smem_bytes(chunk_symbols: int, symbol_size: int) -> int:
    """Largest dynamic shared memory one chunk needs across the kernels.

    Kernel I and the match-only kernel hold the chunk's symbols (S bytes
    each) plus one length byte and one offset byte per position; the two
    decoders hold a 4C-byte row of keys and copy sources (their staged
    layout, which adds the literal row and the two sections, is taken
    only where it fits); Kernel III holds the chunk's
    flag bytes, rounded to words.  The one-launch compressor holds Kernel
    I's rows and, where the symbols were, the emit flags and flag words:
    max(C * S, C + 4 * ceil(C / 32)) + 2 * C, never more than the largest
    of the others (3.125 C against 4 C at S = 1).  The warp-synchronous
    window walk keeps its equality words in registers and adds no shared
    row, so every geometry accepted for the per-thread walk still fits.
    """
    c, s = chunk_symbols, symbol_size
    words = 4 * -(-c // 32)
    return max(c * s + 2 * c, 4 * c, words, max(c * s, c + words) + 2 * c)


def validate_block_geometry(
    chunk_symbols: int, chunks_per_block: int, symbol_size: int
) -> None:
    """Reject a (C, g) pair the Hopper kernels could not run, naming it.

    ``chunks_per_block`` must be a positive int (it travels with configs
    that cross from the reference package) but has no effect on the
    kernels' shared-memory need.
    """
    c, g = chunk_symbols, chunks_per_block
    if not isinstance(g, int) or isinstance(g, bool) or g < 1:
        raise ValueError(
            f"chunks_per_block must be a positive int: got "
            f"(chunk_symbols={c}, chunks_per_block={g!r})"
        )
    need = kernel_smem_bytes(c, symbol_size) + SMEM_STATIC_BYTES
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"block geometry (chunk_symbols={c}, chunks_per_block={g}) needs "
            f"{need} bytes of shared memory per thread block at "
            f"symbol_size={symbol_size}, over the {SMEM_LIMIT_BYTES}-byte "
            f"Hopper limit — shrink chunk_symbols"
        )


def _fits(c: int, s: int) -> bool:
    return kernel_smem_bytes(c, s) + SMEM_STATIC_BYTES <= SMEM_LIMIT_BYTES


# --------------------------------------------------------------- choices


def fallback(key: TuneKey) -> Tuple[int, int]:
    """Deterministic geometry when tuning is disabled (or under a trace)."""
    c, g = None, None
    for (prefix, direction), row in FALLBACK_TABLE.items():
        if key.direction == direction and key.device_kind.startswith(prefix):
            c, g = row
            break
    if c is None:
        c = DEFAULT_CHUNK_SYMBOLS
        g = DEFAULT_CHUNKS_PER_BLOCK
    if key.chunk_symbols is not None:
        c = key.chunk_symbols  # C already committed by the caller's shapes
    return c, g


def candidates(key: TuneKey):
    """Shared-memory-filtered (C, g) candidate list for one key."""
    cs = (
        CHUNK_SYMBOL_CANDIDATES
        if key.chunk_symbols is None
        else (key.chunk_symbols,)
    )
    out = [(c, DEFAULT_CHUNKS_PER_BLOCK) for c in cs if _fits(c, key.symbol_size)]
    return out or [fallback(key)]


# ------------------------------------------------------------- the cache


def validate_cache(obj) -> None:
    """Schema check for an on-disk cache object; raises ``ValueError``.

    Gates ``_load_cache``: a corrupted file is treated as empty, never
    trusted.
    """
    if not isinstance(obj, dict):
        raise ValueError("autotune cache: not a JSON object")
    if obj.get("version") != CACHE_VERSION:
        raise ValueError(
            f"autotune cache: version {obj.get('version')!r} != {CACHE_VERSION}"
        )
    entries = obj.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("autotune cache: 'entries' must be an object")
    for k, e in entries.items():
        if not isinstance(e, dict):
            raise ValueError(f"autotune cache: entry {k!r} is not an object")
        for field in ("chunk_symbols", "chunks_per_block"):
            v = e.get(field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"autotune cache: entry {k!r} field {field!r} must be a "
                    f"positive int, got {v!r}"
                )
        spc = e.get("seconds_per_call")
        if not isinstance(spc, (int, float)) or spc <= 0:
            raise ValueError(
                f"autotune cache: entry {k!r} seconds_per_call must be a "
                f"positive number, got {spc!r}"
            )


def _entry_geometry(cache: dict, key: TuneKey) -> Optional[Tuple[int, int]]:
    """Validated geometry from a persisted cache entry, or ``None``.

    ``validate_cache`` only proves the schema; an entry can still be
    unusable here (the file is shareable and hand-editable, and survives
    changes to the budget).  Re-check on every hit that a fixed-C key only
    adopts an entry tuned for that C and that the pair fits the Hopper
    shared-memory budget; a failing entry is ignored (and overwritten by
    the next sweep).
    """
    entry = cache["entries"].get(key.cache_key())
    if entry is None:
        return None
    c, g = int(entry["chunk_symbols"]), int(entry["chunks_per_block"])
    if key.chunk_symbols is not None and c != key.chunk_symbols:
        return None
    if c % 8 or not _fits(c, key.symbol_size):
        return None
    return c, g


def _load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
        validate_cache(obj)
        return obj
    except FileNotFoundError:
        return {"version": CACHE_VERSION, "entries": {}}
    except (json.JSONDecodeError, ValueError, OSError):
        # corrupted / stale-schema cache: recover by re-tuning, never crash
        return {"version": CACHE_VERSION, "entries": {}}


def _store_cache(path: str, cache: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)
    os.replace(tmp, path)  # atomic publish


def reset() -> None:
    """Drop per-process memoized geometry (tests / env changes)."""
    _MEMO.clear()
    _SWEEPS.clear()


# --------------------------------------------------------------- tuning


def _time(fn: Callable[[], object], warmup: int = 1, iters: int = 2) -> float:
    """Best seconds of ``iters`` calls after ``warmup``: on the card, each
    call between two CUDA events; without one, the host clock."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def sweep_inputs(key: TuneKey, nbytes: Optional[int] = None) -> Callable[[int], tuple]:
    """The sweep's workload for one key: C -> (args, kwargs) of
    ``ops.lz_fused_mono`` (compress) or ``ops.lz_decode_mono`` (decompress).

    Every C sees the same ``nbytes`` of input (``SWEEP_BYTES`` by default,
    rounded down to whole chunks).  Compress: the reference's seeded
    run-heavy corpus (``default_rng(0)`` symbols, each repeated 4 times).
    Decompress: a worst-case all-literal container (every flag and payload
    window at full width) of seeded random bytes.  The tensors lie on the
    card unless the key's device kind is ``"cpu"``.
    """
    import numpy as np

    from repro_torch.core import encode
    from repro_torch.core import format as fmt

    s = key.symbol_size
    dev = torch.device("cpu" if key.device_kind == "cpu" else "cuda")
    n = (SWEEP_BYTES if nbytes is None else nbytes) // s  # symbols
    rng = np.random.default_rng(0)

    if key.direction == "compress":
        window = key.window or DEFAULT_CHUNK_SYMBOLS // 16
        stream = np.repeat(rng.integers(0, 1 << min(8 * s, 16), -(-n // 4)), 4)
        flat = torch.from_numpy(stream.astype(np.int32)[:n]).to(dev)

        def at(c: int) -> tuple:
            nc = n // c
            return (flat[: nc * c].reshape(1, nc, c),), dict(
                window=window, min_match=encode.min_match_length(s), symbol_size=s,
                cap=fmt.max_compressed_bytes(nc * c * s, s, c),
                sec_flags=fmt.HEADER_BYTES + 8 * nc,
            )

        return at

    literals = torch.from_numpy(rng.integers(0, 256, n * s, dtype=np.int64).astype(np.uint8))
    literals = literals.to(dev)

    def at(c: int) -> tuple:
        nc = n // c
        flags = fmt.HEADER_BYTES + 8 * nc + nc * (c // 8)
        blob = torch.zeros(1, flags + nc * c * s, dtype=torch.uint8, device=dev)
        blob[0, flags:] = literals[: nc * c * s]
        nt = torch.full((1, nc), c, dtype=torch.int32, device=dev)  # all-literal
        return (blob, nt, nt * s), dict(symbol_size=s, chunk_symbols=c)

    return at


def _default_measure(
    key: TuneKey, nbytes: Optional[int] = None
) -> Callable[[int, int], float]:
    """Deterministic synthetic workload for one key: (C, g) -> seconds.

    Times the one-launch compressor or decoder on ``sweep_inputs(key,
    nbytes)`` at each C; the kernels run on the card unless the key's
    device kind is ``"cpu"``, where the wrappers run their plain versions.
    """
    from repro_torch.kernels import ops

    op = ops.lz_fused_mono if key.direction == "compress" else ops.lz_decode_mono
    inputs = sweep_inputs(key, nbytes)

    def measure(c: int, g: int) -> float:
        args, kw = inputs(c)
        return _time(lambda: op(*args, **kw))

    return measure


def best_geometry(
    key: TuneKey, measure: Optional[Callable[[int, int], float]] = None
) -> Tuple[int, int]:
    """(chunk_symbols, chunks_per_block) for one key.

    Resolution order: deterministic fallback when tuning is disabled;
    per-process memo; a key with one candidate, memoised without timing or
    file I/O (every fixed-C key on Hopper: one g); the persisted JSON cache
    (entries re-validated on every hit, see ``_entry_geometry``); finally a
    timed sweep over ``candidates(key)`` whose winner is written back to the
    cache.  The result is memoised.

    The sweep never runs while a CUDA graph is captured or torch.compile
    traces (``trace_state_clean``): an untuned key then gets the
    deterministic fallback, unmemoised and unpersisted, so a later eager
    call can still tune it.
    """
    if not enabled():
        return fallback(key)
    ck = key.cache_key()
    if ck in _MEMO:
        return _MEMO[ck]
    cands = candidates(key)
    if len(cands) == 1:
        _MEMO[ck] = cands[0]
        return cands[0]
    path = cache_path()
    cache = _load_cache(path)
    geom = _entry_geometry(cache, key)
    if geom is not None:
        _MEMO[ck] = geom
        return geom
    if not trace_state_clean():
        return fallback(key)  # recorded launches are not timings: never sweep here
    if measure is None:
        measure = _default_measure(key)
    timed = [(measure(c, g), c, g) for c, g in cands]
    _SWEEPS[ck] = _SWEEPS.get(ck, 0) + 1
    best_t, c, g = min(timed)
    cache["entries"][ck] = {
        "chunk_symbols": c,
        "chunks_per_block": g,
        "seconds_per_call": best_t,
        "device_kind": key.device_kind,
        "direction": key.direction,
        "swept": len(timed),
    }
    _store_cache(path, cache)
    _MEMO[ck] = (c, g)
    return c, g


# ----------------------------------------------------- call-site helpers


def tuned_chunk_geometry(
    *, symbol_size: int, window: int, dtype: Optional[str] = None
) -> Tuple[int, int]:
    """Joint (chunk_symbols, chunks_per_block) sweep for new containers.

    C is a *format-visible* parameter (it changes container bytes), so this
    is only consulted when a config is being built (``pipeline.tuned_config``),
    never to reinterpret an existing container.
    """
    key = TuneKey(
        device_kind=device_kind(),
        dtype=dtype or default_dtype(symbol_size),
        symbol_size=symbol_size,
        window=window,
        direction="compress",
        chunk_symbols=None,
    )
    return best_geometry(key)
