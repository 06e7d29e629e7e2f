"""``compress_many``'s batched write (core/lzss.py ``_gather`` and ``_pack``,
core/format.py ``write_headers_and_tables``): the batch is gathered, packed
and given its headers once, not a buffer at a time.

Every layout a caller sends, at S = 1, 2 and 4, gives the reference
package's ``compress_many`` bytes and the bytes of the old per-buffer loop
(``_torch_pack_oracle``).  Rows are padded to the batch's common chunk
count, so a per-buffer ``compress`` is no oracle for a ragged row.  The
ops and host syncs of a call do not grow with the batch, and one buffer
takes no more passes over memory than the per-buffer path did.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_pack_oracle as oracle
from repro.core import lzss as jlzss
from repro_torch.core import format as fmt, lzss
from repro_torch.kernels import ops
from repro_torch.runtime import trace

from _torch_threads import _one_thread  # noqa: F401

C = 64  # symbols a chunk: every batch below has two chunks a row
B = 5  # buffers of every case but "one": one reference compile a symbol size
DTYPES = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _cfg(s, backend="fused-mono"):
    return lzss.LZSSConfig(symbol_size=s, window=32, chunk_symbols=C, backend=backend)


def _bytes(n, seed):
    """``n`` bytes with LZ structure: runs of a few values."""
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 6, n), rng.integers(1, 9, n)).astype(np.uint8)[:n]


def _field(nbytes, s, seed=1):
    """A typed tensor of ``nbytes`` bytes, one element a symbol."""
    return torch.from_numpy(_bytes(nbytes, seed)).view(DTYPES[s])


def _views(field, lengths):
    """Views of ``field`` (no copies), ``lengths`` elements each from its start."""
    out, start = [], 0
    for n in lengths:
        out.append(field[start : start + n])
        start += n
    return out


# Each case: (buffers, rows_packed_alone) for a symbol size.  ``row`` is the
# padded row of two chunks, in bytes.
def _nvcomp_whole(s):
    row = 2 * C * s  # a typed field cut in full rows, the last 5 symbols short
    return _views(_field(B * row, s), [2 * C] * (B - 1) + [2 * C - 5]), 0


def _nvcomp_odd_tail(s):
    row = 2 * C * s  # a byte field cut in full rows, the last 3 bytes short
    return _views(torch.from_numpy(_bytes(B * row, 2)), [row] * (B - 1) + [row - 3]), 0


def _equal_short_last(s):
    # rows of 100 symbols in two-chunk rows; the last shorter, not whole symbols
    return _views(torch.from_numpy(_bytes(B * 100 * s, 3)), [100 * s] * (B - 1) + [37 * s + 1]), 0


def _two_d_array(s):
    return _bytes(B * 100 * s, 4).reshape(B, 100 * s), 0


def _two_d_tensor(s):
    return _field(B * 100 * s, s, seed=5).reshape(B, 100), 0


def _non_contiguous_2d(s):
    return _field(B * 100 * s, s, seed=6).reshape(100, B).T, 0


def _non_contiguous_views(s):
    base = _field(2 * B * 2 * C * s, s, seed=7)
    return [base[2 * i * 2 * C : 2 * (i + 1) * 2 * C : 2] for i in range(B)], 0


def _ragged(s):
    row = 2 * C * s
    return [torch.from_numpy(_bytes(n, 8 + i))
            for i, n in enumerate([row, row // 3 + 1, 7, row - 1, row // 2])], B


def _ragged_whole(s):
    return _views(_field(8 * C * s, s, seed=9), [C, 2 * C, 3, 2 * C - 1, 5]), B


def _zero_byte(s):
    row = 2 * C * s
    sizes = [row, 0, row, row // 2, 0]
    return [torch.from_numpy(_bytes(n, 10 + i)) for i, n in enumerate(sizes)], B


def _zero_byte_last(s):
    return _views(_field(B * 2 * C * s, s, seed=11), [2 * C] * (B - 1) + [0]), 0


def _one(s):
    return [_field(100 * s, s, seed=12)], 0


def _mixed_dtypes(s):
    row = 2 * C * s
    raw = [torch.from_numpy(_bytes(row, 13 + i)) for i in range(B)]
    kinds = [torch.uint8, torch.int16, torch.int32, torch.float32, torch.int16]
    return [r.view(k) for r, k in zip(raw, kinds)][:-1] + [raw[-1][: row - 2].view(torch.int16)], 0


def _mixed_dtypes_host(s):
    row = 2 * C * s
    kinds = [np.uint8, np.int16, np.int32, np.float32, np.uint8]
    return [_bytes(row, 14 + i).view(k) for i, k in enumerate(kinds)][:-1] + [_bytes(9, 18)], 0


def _host_kinds(s):
    row = 2 * C * s
    b = [_bytes(row, 20 + i) for i in range(B)]
    return [b[0], b[1].tobytes(), torch.from_numpy(b[2]), bytearray(b[3].tobytes()), b[4][:11]], 0


def _numpy(s):
    row = 2 * C * s
    return [_bytes(row, 25 + i) for i in range(B - 1)] + [_bytes(row - s, 30)], 0


CASES = {
    "nvcomp-whole-symbols": _nvcomp_whole,
    "nvcomp-odd-tail": _nvcomp_odd_tail,
    "equal-rows-short-last": _equal_short_last,
    "2d-array": _two_d_array,
    "2d-tensor": _two_d_tensor,
    "non-contiguous-2d": _non_contiguous_2d,
    "non-contiguous-views": _non_contiguous_views,
    "ragged": _ragged,
    "ragged-whole-symbols": _ragged_whole,
    "zero-byte": _zero_byte,
    "zero-byte-last": _zero_byte_last,
    "one-buffer": _one,
    "mixed-dtypes": _mixed_dtypes,
    "mixed-dtypes-host": _mixed_dtypes_host,
    "numpy-bytes-and-cpu-tensors": _host_kinds,
    "numpy": _numpy,
}


def _for_reference(arrays):
    """The case as the reference takes it: numpy arrays and bytes."""
    if isinstance(arrays, torch.Tensor):
        return arrays.numpy()
    if isinstance(arrays, np.ndarray):
        return arrays
    return [a.numpy() if isinstance(a, torch.Tensor) else a for a in arrays]


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("s", [1, 2, 4])
def test_batch_equals_the_reference_and_the_per_buffer_loop(tracing, s, case):
    arrays, alone = CASES[case](s)
    cfg = _cfg(s)
    got = lzss.compress_many(arrays, cfg, device="cpu")
    assert tracing.snapshot()["counters"]["rows_packed_alone"] == alone
    want_data, want_totals, want_sizes = oracle.compress_many(arrays, cfg, "cpu")
    assert np.array_equal(got.data, want_data)
    assert got.total_bytes.tolist() == want_totals
    assert got.orig_bytes.tolist() == want_sizes
    ref = jlzss.compress_many(_for_reference(arrays),
                              jlzss.LZSSConfig(symbol_size=s, window=32, chunk_symbols=C))
    assert np.array_equal(got.data, ref.data)
    assert np.array_equal(got.total_bytes, ref.total_bytes)
    assert np.array_equal(got.orig_bytes, ref.orig_bytes)


@pytest.mark.parametrize("backend", ["torch", "fused-deflate"])
@pytest.mark.parametrize("case", ["nvcomp-odd-tail", "ragged"])
def test_every_raw_backend_finalises_the_batch_alike(backend, case):
    arrays, _ = CASES[case](2)
    got = lzss.compress_many(arrays, _cfg(2, backend), device="cpu")
    want_data, want_totals, _ = oracle.compress_many(arrays, _cfg(2), "cpu")
    assert np.array_equal(got.data, want_data) and got.total_bytes.tolist() == want_totals


def _aten_ops(fn) -> list:
    """The ATen ops that ``fn`` calls itself, sorted: not those an op calls
    inside (``torch.cat`` splits a long list of inputs inside one call)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(e.name for e in prof.events() if e.name.startswith("aten::")
                  and not (e.cpu_parent and e.cpu_parent.name.startswith("aten::")))


# ops that only make a view or take memory, and neither read nor write it
_NO_PASS = {"aten::view", "aten::slice", "aten::reshape", "aten::unsqueeze", "aten::select",
            "aten::as_strided", "aten::detach", "aten::lift_fresh", "aten::empty"}


def _passes(fn) -> list:
    """The ops of ``fn`` that read or write memory: a copy, a fill, a cast."""
    return [n for n in _aten_ops(fn) if n not in _NO_PASS]


def _stub_compressor(symbols, *, window, min_match, symbol_size, cap, sec_flags):
    """The one-launch compressor's outputs in a fixed number of ops."""
    b, nc, _ = symbols.shape
    i32 = dict(dtype=torch.int32, device=symbols.device)
    return (torch.zeros(b, cap, dtype=torch.uint8, device=symbols.device),
            torch.ones(b, nc, **i32), torch.ones(b, nc, **i32), torch.ones(b, 2, **i32))


def _layout(kind, b, s):
    row = 2 * C  # elements of a typed field, one a symbol
    field = _field(b * row * s, s, seed=b)
    if kind == "full-rows":
        return list(field.split(row))
    if kind == "short-last":
        return _views(field, [row] * (b - 1) + [row - 7])
    return field.reshape(b, row)[:, :100]  # a 2-D input, rows shorter than the row


@pytest.mark.parametrize("kind", ["full-rows", "short-last", "2d"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_ops_and_host_syncs_do_not_grow_with_the_batch(tracing, monkeypatch, kind, s):
    monkeypatch.setattr(ops, "lz_fused_mono", _stub_compressor)

    def one_call(b):
        arrays = _layout(kind, b, s)
        tracing.reset()
        names = _aten_ops(lambda: lzss.compress_many(arrays, _cfg(s), device="cpu"))
        counters = tracing.snapshot()["counters"]
        return names, counters["host_syncs"], counters["rows_packed_alone"]

    small, large = one_call(8), one_call(256)
    assert small == large
    assert small[1] == 2 and small[2] == 0  # the totals' read and the batch's D2H




@pytest.mark.parametrize("extra", [0, 1])  # whole symbols, or a partial last one
@pytest.mark.parametrize("s", [1, 2, 4])
def test_one_buffer_takes_no_more_passes_than_the_per_buffer_path(s, extra):
    cfg = _cfg(s)
    n = 300 * s + extra
    raw = torch.from_numpy(_bytes(n, 40))
    nc = lzss._n_chunks(n, cfg)
    assert len(_passes(lambda: lzss._pack(raw, [n], cfg))) <= len(_passes(
        lambda: oracle.pack_padded(raw, nc, cfg)))
    assert torch.equal(lzss._pack(raw, [n], cfg)[0], oracle.pack_padded(raw, nc, cfg))
    nt = torch.arange(nc, dtype=torch.int32)
    fields = dict(symbol_size=s, window=32, chunk_symbols=C, n_chunks=nc, orig_bytes=n,
                  payload_total=70, flag_total=9)
    cap = fmt.HEADER_BYTES + 8 * nc
    new, old = torch.zeros(cap, dtype=torch.uint8), torch.zeros(cap, dtype=torch.uint8)
    tables = nt + 1
    assert len(_passes(lambda: fmt.write_header_and_tables(
        new, n_tokens=nt, payload_sizes=tables, **fields))) <= len(_passes(
        lambda: oracle.write_header_and_tables(old, n_tokens=nt, payload_sizes=tables, **fields)))
    assert torch.equal(new, old)


def test_header_rows_are_the_field_by_field_bytes():
    rng = np.random.default_rng(3)
    orig, pay, flag = (rng.integers(0, 1 << 40, 6) for _ in range(3))
    rows = fmt.header_rows(symbol_size=4, window=255, chunk_symbols=32768, n_chunks=70000,
                           orig_bytes=orig, payload_total=pay, flag_total=flag)
    assert rows.shape == (6, fmt.HEADER_BYTES) and rows.dtype == np.uint8
    for r, o, p, f in zip(rows, orig, pay, flag):
        want = oracle.header_bytes(symbol_size=4, window=255, chunk_symbols=32768, n_chunks=70000,
                                   orig_bytes=int(o), payload_total=int(p), flag_total=int(f))
        assert r.tobytes() == want
        h = fmt.parse_header(r)
        assert (h.orig_bytes, h.payload_bytes, h.flag_bytes) == (o, p, f)


def test_an_empty_batch_raises():
    for empty in ([], np.zeros((0, 8), np.uint8), torch.zeros(0, 8, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="at least one buffer"):
            lzss.compress_many(empty, _cfg(2), device="cpu")
