"""The decoder kernel: per-chunk aligned sections -> symbols.

The CUDA kernel is ``csrc/lz_decode.cu`` (one thread block per chunk, the
decode chain of ``csrc/decode_chunk.cuh``); it replaces the TPU kernel
``repro/kernels/lz_decode.py:_decode_kernel``.
``lz_decode_plain`` is its plain PyTorch version (``core/decode.py``'s
parallel decoder); ``kernels/ops.py`` chooses by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import autotune, decode
from repro_torch.kernels import _build


def lz_decode_plain(flag_bytes, payload, n_tokens, *, symbol_size):
    """(N, C//8) flag bytes + (N, C*S) payload bytes + (N,) token counts ->
    (N, C) int32 symbols."""
    return decode.decode_parallel(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


def lz_decode_cuda(flag_bytes, payload, n_tokens, *, symbol_size):
    """The same function by one launch of the CUDA decoder."""
    for t in (flag_bytes, payload, n_tokens):
        if t.device.type != "cuda":
            raise ValueError(f"the decoder takes CUDA tensors, got one on {t.device}")
    n, cb = flag_bytes.shape
    c = cb * 8
    if tuple(payload.shape) != (n, c * symbol_size) or tuple(n_tokens.shape) != (n,):
        raise ValueError(
            f"decoder shapes: flags {tuple(flag_bytes.shape)}, payload "
            f"{tuple(payload.shape)}, n_tokens {tuple(n_tokens.shape)} at "
            f"symbol_size={symbol_size}"
        )
    autotune.validate_block_geometry(c, 1, symbol_size)
    fb = flag_bytes.to(torch.uint8).contiguous()
    pay = payload.to(torch.uint8).contiguous()
    nt = n_tokens.to(torch.int32).contiguous()
    out = torch.empty(n, c, dtype=torch.int32, device=fb.device)  # the kernel writes it all
    lib = _build.library("lz_decode")
    code = lib.lz_decode_launch(
        fb.data_ptr(), pay.data_ptr(), nt.data_ptr(), n, c, symbol_size,
        out.data_ptr(), torch.cuda.current_stream(fb.device).cuda_stream,
    )
    _build.check(lib, code, "decoder (lz_decode_launch)")
    return out


def decode_occupancy(*, symbol_size, chunk_symbols):
    """{kernel: (registers a thread, resident blocks per SM)} of the two
    decoders (the split one and the one-launch one) in the shared-memory
    layout they take at this geometry, from the CUDA occupancy API."""
    out = (ctypes.c_int * 2)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    res = {}
    for name in ("lz_decode", "lz_decode_mono"):
        lib = _build.library(name)
        fn = getattr(lib, f"{name}_occupancy")
        _build.check(lib, fn(symbol_size, chunk_symbols, ptr), f"{name} occupancy")
        res[name] = (out[0], out[1])
    return res
