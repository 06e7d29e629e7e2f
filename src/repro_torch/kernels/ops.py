"""Public wrappers of the port's CUDA kernels, with launch counts.

Each wrapper launches its CUDA kernel for CUDA tensors, or raises; it runs
the kernel's plain PyTorch version only for CPU tensors (which is what the
CPU tests give it).  There is no fallback from a failed build or launch.
``LAUNCHES`` counts, per kernel, the launches the wrappers made: a count
goes up only where its kernel was launched, never for the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import lz_bitshuffle as _bshuf
from repro_torch.kernels import lz_decode as _dec
from repro_torch.kernels import lz_decode_mono as _dmono
from repro_torch.kernels import lz_entropy as _ent
from repro_torch.kernels import lz_fused as _fused
from repro_torch.kernels import lz_match as _match
from repro_torch.kernels import lz_scatter as _scat

KERNELS = (
    "lz_kernel1", "lz_global_offsets", "lz_scatter", "lz_decode",
    "lz_fused_mono", "lz_decode_mono", "lz_match",
    "byte_histogram", "huffman_gap_decode", "bitshuffle", "bitunshuffle",
)
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


def lz_fused_mono(symbols, *, window, min_match, symbol_size, cap, sec_flags):
    """Kernels I+II+III in one launch: (B, nc, C) int32 symbols -> ((B, cap)
    uint8 blobs holding the sections, (B, nc) n_tokens, (B, nc)
    payload_sizes, (B, 2) totals)."""
    kw = dict(window=window, min_match=min_match, symbol_size=symbol_size, cap=cap,
              sec_flags=sec_flags)
    if _on_cpu(symbols):
        return _fused.lz_fused_mono_plain(symbols, **kw)
    out = _fused.lz_fused_mono_cuda(symbols, **kw)
    LAUNCHES["lz_fused_mono"] += 1
    return out


def lz_decode_mono(blobs, n_tokens, payload_sizes, *, symbol_size, chunk_symbols):
    """The decoder in one launch: (B, L) uint8 container blobs + (B, nc) A/B
    tables -> (B, nc, C) int32 symbols."""
    kw = dict(symbol_size=symbol_size, chunk_symbols=chunk_symbols)
    if _on_cpu(blobs):
        return _dmono.lz_decode_mono_plain(blobs, n_tokens, payload_sizes, **kw)
    out = _dmono.lz_decode_mono_cuda(blobs, n_tokens, payload_sizes, **kw)
    LAUNCHES["lz_decode_mono"] += 1
    return out


def lz_match(symbols, *, window, symbol_size):
    """Matching only: (N, C) int32 symbols -> (lengths, offsets) (N, C) int32."""
    if _on_cpu(symbols):
        return _match.lz_match_plain(symbols, window=window, symbol_size=symbol_size)
    out = _match.lz_match_cuda(symbols, window=window, symbol_size=symbol_size)
    LAUNCHES["lz_match"] += 1
    return out


def byte_histogram(buf, start, length):
    """(256,) int32 counts of the byte values of ``buf[start : start + length]``."""
    if _on_cpu(buf):
        return _ent.byte_histogram_plain(buf, start, length)
    out = _ent.byte_histogram_cuda(buf, start, length)
    if length:  # an empty range launches nothing
        LAUNCHES["byte_histogram"] += 1
    return out


def huffman_gap_decode(blob, wstarts, rems, first, count, base, order, *, sub):
    """Gap-array canonical-Huffman decode: (nsub,) entry points + canonical
    tables -> (nsub, sub) uint8 symbols."""
    args = (blob, wstarts, rems, first, count, base, order)
    if _on_cpu(blob):
        return _ent.huffman_gap_decode_plain(*args, sub=sub)
    out = _ent.huffman_gap_decode_cuda(*args, sub=sub)
    if wstarts.numel():
        LAUNCHES["huffman_gap_decode"] += 1
    return out


def bitshuffle(units, out=None):
    """(N,) int16 units -> (2N,) uint8 bit planes, N % 512 == 0; with
    ``out``, written into its prefix and that prefix returned."""
    if _on_cpu(units):
        return _bshuf.write_into(out, _bshuf.bitshuffle_plain(units), "bitshuffle")
    res = _bshuf.bitshuffle_cuda(units, out)
    if units.numel():
        LAUNCHES["bitshuffle"] += 1
    return res


def bitunshuffle(shuffled):
    """(2N,) uint8 bit planes -> (N,) int16 units."""
    if _on_cpu(shuffled):
        return _bshuf.bitunshuffle_plain(shuffled)
    out = _bshuf.bitunshuffle_cuda(shuffled)
    if shuffled.numel():
        LAUNCHES["bitunshuffle"] += 1
    return out
