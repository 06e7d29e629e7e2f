"""Plain PyTorch oracles for the CUDA kernels.

``ref.lz_match`` / ``ref.lz_kernel1`` give exactly the values the kernels
must give; integer outputs, so the tests and ``chip_smoke.py`` hold the
kernels to exact equality.
"""

from __future__ import annotations

import torch

from repro_torch.core import encode as encode_mod
from repro_torch.core import match as match_mod


def lz_match(symbols, *, window, max_len=match_mod.MAX_LEN_CAP):
    return match_mod.find_matches(
        symbols.to(torch.int32), window=window, max_len=max_len
    )


def lz_kernel1(
    symbols, *, window, min_match, symbol_size, max_len=match_mod.MAX_LEN_CAP
):
    lengths, offsets = lz_match(symbols, window=window, max_len=max_len)
    emitted = encode_mod.select_tokens_scan(lengths, min_match=min_match)
    fields = encode_mod.token_fields(
        lengths, emitted, min_match=min_match, symbol_size=symbol_size
    )
    return dict(
        lengths=lengths,
        offsets=offsets,
        emitted=emitted,
        local_off=fields["local_off"],
        payload_sizes=fields["payload_sizes"],
        n_tokens=fields["n_tokens"],
    )
