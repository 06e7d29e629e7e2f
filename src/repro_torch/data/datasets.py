"""Surrogates for the paper's six evaluation datasets (the PyTorch port's copy).

The generators are those of the reference package's ``data/datasets.py``,
seeded numpy; the quant-code surrogates quantize through this package's
``core/quant.py``, and ``load`` gives the same bytes as the reference's.

The TPC-H / SDRBench files are not redistributable offline, so each surrogate
is generated to match the *statistical character* that drives LZSS behaviour
(symbol width, smoothness -> quant-code redundancy, run structure).  The
paper's measured ratios at the default config (C=2048, S=2, W=128) are kept
next to each generator as calibration targets; benchmarks print both.

  dataset        paper CR (S=2, W=128, C=2048)   type
  hurr-quant     4.91                            uint16 quant codes
  hacc-quant     1.97                            uint16 quant codes
  nyx-quant      7.19                            uint16 quant codes
  tpch-int32     1.34                            int32 columns
  tpch-string    2.43                            utf-8 text
  rtm-float32    2.84                            float32 field
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant

PAPER_RATIOS_DEFAULT = {
    "hurr-quant": 4.91,
    "hacc-quant": 1.97,
    "nyx-quant": 7.19,
    "tpch-int32": 1.34,
    "tpch-string": 2.43,
    "rtm-float32": 2.84,
}


def _quant_codes(field: np.ndarray, rel_eb: float, ndim: int) -> np.ndarray:
    eb = quant.relative_error_bound(field, rel_eb)
    q = quant.quantize(torch.from_numpy(field), error_bound=eb, ndim=ndim)
    return q.codes.numpy().astype(np.uint16)


def _hurr_raw_field(n: int, seed: int = 0) -> np.ndarray:
    """The smooth weather field both hurr surrogates derive from."""
    side = int(np.sqrt(n))
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side].astype(np.float32) / side
    return (
        np.sin(6 * np.pi * x) * np.cos(4 * np.pi * y) * 30
        + np.cumsum(rng.normal(0, 0.1, (side, side)).astype(np.float32),
                    axis=1)
    )


def hurr_quant(nbytes: int = 1 << 22, seed: int = 0) -> np.ndarray:
    """Weather-field quant codes: smooth 2D with fronts (moderate runs)."""
    n = nbytes // 2
    field = _hurr_raw_field(n, seed)
    return _quant_codes(field, 1e-3, 2).reshape(-1)[:n]


def hurr_field(nbytes: int = 1 << 22, seed: int = 0) -> np.ndarray:
    """The hurr surrogate's pre-quantization float32 field — the natural
    input for the error-bounded lossy frontend (benchmarks/fig_lossy.py),
    where quantization happens INSIDE the codec against a caller-chosen
    bound instead of up front at a fixed one."""
    n = nbytes // 4
    field = _hurr_raw_field(n, seed).reshape(-1)
    pad = np.zeros(max(0, n - field.size), np.float32)
    return np.concatenate([field, pad])[:n].view(np.uint8)


def hacc_quant(nbytes: int = 1 << 22, seed: int = 1) -> np.ndarray:
    """Cosmology-particle quant codes: rough, short-run redundancy (the
    paper's lowest-ratio quant dataset, ~2x at S=2/W=128)."""
    n = nbytes // 2
    rng = np.random.default_rng(seed)
    # particle coords: ~half the samples sit in tiny clusters (short runs of
    # equal codes), the rest jump randomly — short-run redundancy only
    base = rng.uniform(0, 1, n).astype(np.float32)
    repeat = rng.random(n) < 0.68
    repeat[0] = False
    idx = np.where(repeat, 0, np.arange(n))
    idx = np.maximum.accumulate(idx)   # forward-fill to cluster anchors
    field = base[idx]
    return _quant_codes(field, 1e-3, 1)[:n]


def nyx_quant(nbytes: int = 1 << 22, seed: int = 2) -> np.ndarray:
    """Cosmology-grid quant codes: very smooth 3D -> long runs."""
    n = nbytes // 2
    side = max(8, int(round(n ** (1 / 3))))
    z, y, x = np.mgrid[0:side, 0:side, 0:side].astype(np.float32) / side
    field = (
        np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y) * np.sin(2 * np.pi * z)
    ) * 100 + 3 * x * y
    return _quant_codes(field, 1e-3, 3).reshape(-1)[:n]


def tpch_int32(nbytes: int = 1 << 22, seed: int = 3) -> np.ndarray:
    """Business columns: keys/dates/quantities, low run redundancy."""
    n = nbytes // 4
    rng = np.random.default_rng(seed)
    cols = [
        rng.integers(1, 200_000, n // 4),          # orderkey-ish (random)
        rng.integers(0, 2526, n // 4) + 728_000,   # dates (narrow range)
        rng.integers(1, 51, n // 4),               # quantity (small ints)
        (rng.integers(90_000, 105_000, n // 4)),   # extended price
    ]
    arr = np.concatenate(cols).astype(np.int32)
    return arr.view(np.uint8).reshape(-1)[: n * 4].view(np.uint8)


_WORDS = (
    "the of and to in a is that for it as was with be by on not he i this are "
    "or his from at which but have an had they you were their one all we can "
    "her has there been if more when will would who so no said what up its "
    "about into than them only other time new some could these two may then do"
).split()


def tpch_string(nbytes: int = 1 << 22, seed: int = 4) -> np.ndarray:
    """Comment-style text: zipfian words, repeated phrases."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.5, nbytes // 4), len(_WORDS)) - 1
    words = [_WORDS[r] for r in ranks]
    text = " ".join(words).encode()[:nbytes]
    return np.frombuffer(text, np.uint8)


def rtm_float32(nbytes: int = 1 << 22, seed: int = 5) -> np.ndarray:
    """Seismic wavefield: raw float32 — quiet zones (exact zeros) between
    repeating source wavelets, like pre-stack RTM snapshots (~2.9x at S=4)."""
    n = nbytes // 4
    rng = np.random.default_rng(seed)
    wavelet = (np.sin(np.linspace(0, 4 * np.pi, 48))
               * np.hanning(48) * 100).astype(np.float32)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos + 64 < n:
        amp = np.float32(2.0 ** rng.integers(-2, 3))  # exact-pow2 scaling
        out[pos : pos + 48] = wavelet * amp           # keeps bit patterns
        pos += 48 + int(rng.integers(16, 96))         # quiet gap
    return out.view(np.uint8)


DATASETS = {
    "hurr-quant": (hurr_quant, np.uint16),
    "hurr-field": (hurr_field, np.float32),
    "hacc-quant": (hacc_quant, np.uint16),
    "nyx-quant": (nyx_quant, np.uint16),
    "tpch-int32": (tpch_int32, np.int32),
    "tpch-string": (tpch_string, np.uint8),
    "rtm-float32": (rtm_float32, np.float32),
}


def load(name: str, nbytes: int = 1 << 22) -> np.ndarray:
    gen, _ = DATASETS[name]
    out = gen(nbytes)
    return np.ascontiguousarray(out).view(np.uint8).reshape(-1)
