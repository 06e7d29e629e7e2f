"""Deterministic, resumable data pipeline (the PyTorch port).

Every batch is a pure function of (seed, step), so restart-from-checkpoint
resumes the stream exactly (no iterator state to persist).  Sources:
synthetic LM token streams (zipfian n-gram mixture, so compression and
benchmark paths see realistic redundancy) or a memory-mapped int32 token
file.  The batches are numpy, byte-identical to the reference package's for
every (seed, step); ``Prefetcher`` puts them on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"   # synthetic | mmap
    path: str = ""              # for mmap


def _rng_for(cfg: DataConfig, step: int):
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xC0FFEE])
    )


def synthetic_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """Zipf-ish LM stream with repeated n-grams (so LZ paths see structure)."""
    rng = _rng_for(cfg, step)
    b, t = cfg.global_batch, cfg.seq_len
    # zipf over a capped vocab; repeat phrases to create spatial redundancy
    base = rng.zipf(1.3, size=(b, t)).astype(np.int64)
    toks = (base % cfg.vocab_size).astype(np.int32)
    span = min(32, t // 2)
    if span:
        for _ in range(max(1, t // 256)):
            src = rng.integers(0, t - span + 1)
            dst = rng.integers(0, t - span + 1)
            toks[:, dst : dst + span] = toks[:, src : src + span]
    return toks


def mmap_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    data = np.memmap(cfg.path, dtype=np.int32, mode="r")
    b, t = cfg.global_batch, cfg.seq_len
    n_batches = max(1, (data.size - 1) // (b * t))
    off = (step % n_batches) * b * t
    return np.array(data[off : off + b * t]).reshape(b, t)


def make_batch_for_step(cfg: DataConfig, step: int) -> dict:
    toks = (
        synthetic_tokens(cfg, step)
        if cfg.source == "synthetic"
        else mmap_tokens(cfg, step)
    )
    return {"tokens": toks}


class Prefetcher:
    """One-step lookahead prefetch (compute/data overlap).

    ``device=None`` keeps the host numpy batches.  With a device each batch
    arrives there as ``torch.int32`` tensors; on ``cuda`` the next step's
    batch is copied from a pinned host buffer with ``non_blocking=True``
    while the caller works on the current one.
    """

    def __init__(self, cfg: DataConfig, start_step: int, device=None):
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self._next_step = start_step
        self._buf = self._load(start_step)

    def _load(self, step):
        batch = make_batch_for_step(self.cfg, step)
        if self.device is None:
            return batch
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v, np.int32))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        return out

    def next(self):
        out = self._buf
        self._next_step += 1
        self._buf = self._load(self._next_step)
        return out
