"""Public wrappers of the port's four CUDA kernels, with launch counts.

Each wrapper launches its CUDA kernel for CUDA tensors, or raises; it runs
the kernel's plain PyTorch version only for CPU tensors (which is what the
CPU tests give it).  There is no fallback from a failed build or launch.
``LAUNCHES`` counts, per kernel, the launches the wrappers made: a count
goes up only where its kernel was launched, never for the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import lz_decode as _dec
from repro_torch.kernels import lz_match as _match
from repro_torch.kernels import lz_scatter as _scat

KERNELS = ("lz_kernel1", "lz_global_offsets", "lz_scatter", "lz_decode")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, not {t.device}")
    return False


def lz_kernel1(symbols, *, window, min_match, symbol_size):
    """Kernel I: (N, C) int32 symbols -> dict(lengths, offsets, emitted,
    local_off, payload_sizes, n_tokens)."""
    kw = dict(window=window, min_match=min_match, symbol_size=symbol_size)
    if _on_cpu(symbols):
        return _match.lz_kernel1_plain(symbols, **kw)
    out = _match.lz_kernel1_cuda(symbols, **kw)
    LAUNCHES["lz_kernel1"] += 1
    return out


def lz_global_offsets(n_tokens, payload_sizes):
    """Kernel II: (rows, nc) sizes -> (flag_off, pay_off pre-based by the
    flag total, (rows, 2) totals)."""
    if _on_cpu(n_tokens):
        return _scat.global_offsets_plain(n_tokens, payload_sizes)
    out = _scat.global_offsets_cuda(n_tokens, payload_sizes)
    LAUNCHES["lz_global_offsets"] += 1
    return out


def lz_scatter(symbols, lengths, offsets, emitted, local_off, flag_off, pay_off,
               *, symbol_size, min_match, cap, sec_flags):
    """Kernel III: (rows, nc, C) Kernel-I outputs + (rows, nc) offsets ->
    (rows, cap) uint8 blobs holding the flag and payload sections."""
    args = (symbols, lengths, offsets, emitted, local_off, flag_off, pay_off)
    kw = dict(symbol_size=symbol_size, min_match=min_match, cap=cap, sec_flags=sec_flags)
    if _on_cpu(symbols):
        return _scat.scatter_plain(*args, **kw)
    out = _scat.scatter_cuda(*args, **kw)
    LAUNCHES["lz_scatter"] += 1
    return out


def lz_decode(flag_bytes, payload, n_tokens, *, symbol_size):
    """Decoder: (N, C//8) flags + (N, C*S) payload + (N,) counts -> (N, C)
    int32 symbols."""
    if _on_cpu(flag_bytes):
        return _dec.lz_decode_plain(flag_bytes, payload, n_tokens, symbol_size=symbol_size)
    out = _dec.lz_decode_cuda(flag_bytes, payload, n_tokens, symbol_size=symbol_size)
    LAUNCHES["lz_decode"] += 1
    return out
