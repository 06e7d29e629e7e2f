"""LZSS decompression: the plain PyTorch decoders.

Two decoders over per-chunk aligned sections (the tensors
``deflate.gather_section`` rebuilds from a container):

  * ``decode_scan``     — sequential token walk per chunk (a loop over token
    slots, all chunks at once).  The paper's decompression parallelism
    (chunk level only); kept as the oracle.
  * ``decode_parallel`` — fully parallel decoder.  Because match length <=
    offset (match.py), a copied symbol's source lies strictly before the
    copy's own token, so back-references form a forest rooted at literals.
    Token read/write offsets come from two prefix sums (over [2|S] byte
    sizes and over output lengths), and chained copies resolve with
    ceil(log2 C) rounds of pointer doubling.

Inputs are (nc, C//8) flag bytes, (nc, C*S) payload bytes (any integer
dtype) and (nc,) token counts; the output is (nc, C) int32 symbols.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.match import MAX_LEN_CAP


def decode_parallel(flag_bytes, payload, n_tokens, *, symbol_size):
    nc, cb = flag_bytes.shape
    c = cb * 8
    s = symbol_size
    dev = flag_bytes.device
    fb = flag_bytes.to(torch.int32)
    pay = payload.to(torch.int32)
    t = torch.arange(c, device=dev, dtype=torch.int64)[None, :].expand(nc, c)
    active = (t < n_tokens.to(torch.int64)[:, None]).to(torch.int32)

    flags = ((torch.gather(fb, 1, t // 8) >> (t % 8).to(torch.int32)) & 1) * active
    read_size = torch.where(active == 1, torch.where(flags == 1, 2, s), 0)
    rcsum = torch.cumsum(read_size, 1)
    read_off = rcsum - read_size

    def pay_at(k):
        return torch.gather(pay, 1, torch.clamp(read_off + k, 0, pay.shape[1] - 1))

    ln = torch.where(flags == 1, pay_at(0), 1) * active
    off = torch.where(flags == 1, pay_at(1), 0) * active
    lit = torch.zeros(nc, c, dtype=torch.int32, device=dev)
    for b in range(s):
        lit = lit + (pay_at(b) << (8 * b))
    lit = torch.where(flags == 0, lit, 0)

    wcsum = torch.cumsum(ln, 1)
    out_pos = wcsum - ln  # token write start (symbols)

    # Per-output-symbol token id: scatter token starts, then prefix-sum fill.
    starts = torch.zeros(nc, c + 1, dtype=torch.int32, device=dev)
    dest = torch.where((active == 1) & (ln > 0) & (out_pos < c), out_pos, c)
    starts.scatter_add_(1, dest.to(torch.int64), torch.ones_like(ln, dtype=torch.int32))
    token_id = torch.clamp(torch.cumsum(starts[:, :c], 1) - 1, 0, c - 1)

    w = t
    flag_w = torch.gather(flags, 1, token_id)
    off_w = torch.gather(off, 1, token_id)
    lit_w = torch.gather(lit, 1, token_id)
    src = torch.where(flag_w == 1, torch.clamp(w - off_w, 0, c - 1), w)
    for _ in range(max(1, math.ceil(math.log2(c)))):
        src = torch.gather(src, 1, src)
    return torch.gather(lit_w, 1, src).to(torch.int32)


def decode_scan(flag_bytes, payload, n_tokens, *, symbol_size, max_len=MAX_LEN_CAP):
    """Oracle decoder: sequential token walk (a loop over token slots)."""
    nc, cb = flag_bytes.shape
    c = cb * 8
    s = symbol_size
    dev = flag_bytes.device
    fb = flag_bytes.to(torch.int32)
    pay = payload.to(torch.int32)
    nt = n_tokens.to(torch.int64)
    rows = torch.arange(nc, device=dev)
    k = torch.arange(max_len, device=dev, dtype=torch.int64)[None, :]
    out = torch.zeros(nc, c + 1, dtype=torch.int32, device=dev)  # column c: dropped
    rp = torch.zeros(nc, dtype=torch.int64, device=dev)
    wp = torch.zeros(nc, dtype=torch.int64, device=dev)

    def pay_at(idx):
        return pay[rows, torch.clamp(idx, 0, pay.shape[1] - 1)]

    for t in range(c):
        active = t < nt
        flag = (fb[:, t // 8] >> (t % 8)) & 1
        is_m = (flag == 1) & active
        is_l = (flag == 0) & active
        ln = pay_at(rp).to(torch.int64)
        off = pay_at(rp + 1).to(torch.int64)
        sym = torch.zeros(nc, dtype=torch.int32, device=dev)
        for b in range(s):
            sym = sym + (pay_at(rp + b) << (8 * b))
        # match copy (len <= off => source fully decoded, no overlap)
        src_idx = torch.clamp(wp[:, None] - off[:, None] + k, 0, c - 1)
        vals = torch.gather(out, 1, src_idx)
        mask = (k < ln[:, None]) & is_m[:, None]
        dst = torch.where(mask, torch.clamp(wp[:, None] + k, max=c), c)
        out.scatter_add_(1, dst, torch.where(mask, vals, 0))
        dst_l = torch.where(is_l, torch.clamp(wp, max=c), c)
        out[rows, dst_l] += torch.where(is_l, sym, 0)
        rp = rp + torch.where(active, torch.where(is_m, 2, s), 0)
        wp = wp + torch.where(active, torch.where(is_m, ln, 1), 0)
    return out[:, :c]
