"""Lightweight parameter selection (paper §3.2.3), in PyTorch.

The paper's rule:
  * default: S = sizeof(dtype), W = 128, C = 2048;
  * monitor the average compression ratio over the fields seen so far; if it
    is low (< 1.5) switch back to single-byte matching (multi-byte matching
    hides byte-level repeats on low-redundancy data, cf. tpch-int32);
  * when multi-byte matching is kept, the window may be enlarged (the S-fold
    throughput win pays for the larger W);
  * user-facing window levels 1-4 = 32/64/128/255 trade ratio for throughput.

The ratios are exact (container bytes are the same on every device and in
both packages), so the same fields pick the same configs on the card, on
the CPU and in the reference package.  ``device`` goes to ``core.compress``:
``None`` is the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lzss import LZSSConfig, WINDOW_LEVELS, compress

RATIO_THRESHOLD = 1.5


def dtype_symbol_size(dtype) -> int:
    size = np.dtype(dtype).itemsize
    return size if size in (1, 2, 4) else 4


@dataclasses.dataclass
class ParamSelector:
    """Streaming selector: feed fields, get the adapted config."""

    dtype: np.dtype
    level: int = 3                  # window level 1-4
    chunk_symbols: int = 2048
    enlarge_window: bool = True
    _ratios: list = dataclasses.field(default_factory=list)

    def current_config(self) -> LZSSConfig:
        s = dtype_symbol_size(self.dtype)
        if self._ratios and float(np.mean(self._ratios)) < RATIO_THRESHOLD:
            s = 1  # paper: fall back to byte matching on low-redundancy data
        w = WINDOW_LEVELS[self.level]
        if s > 1 and self.enlarge_window:
            w = min(255, w * 2) if self.level < 4 else 255
        return LZSSConfig(symbol_size=s, window=w, chunk_symbols=self.chunk_symbols)

    def observe(self, field, device=None) -> LZSSConfig:
        """Compress one field with the current config; update the running stats."""
        cfg = self.current_config()
        res = compress(field, cfg, device)
        self._ratios.append(res.ratio)
        return cfg

    @property
    def mean_ratio(self) -> float:
        return float(np.mean(self._ratios)) if self._ratios else 0.0


def select_params(sample, level: int = 3, device=None) -> LZSSConfig:
    """One-shot variant: probe multi-byte vs single-byte on a sample."""
    sample = np.asarray(sample)
    sel = ParamSelector(dtype=sample.dtype, level=level)
    sel.observe(sample, device)
    return sel.current_config()
