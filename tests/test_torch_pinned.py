"""The host API's page-locked staging: on a CUDA device ``lzss.decompress``'s
container host copy and result, and ``compress``'s and ``compress_many``'s
containers, live in page-locked blocks of torch's caching host allocator;
on the CPU in pageable memory as before.

The CPU cases hold the CPU paths to what they returned before (the bytes, a
writable uint8 array of ``orig_bytes``, ``total_bytes`` or (B, cap),
nothing staged through page-locked memory), a kept result to its bytes
over later calls, a corrupt container to its ``ValueError``, and the
staging sites to their counts on a pageable stand-in for the allocator.
The ``gpu`` cases run on the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_pinned.py

This file imports no JAX.
"""

import warnings

import numpy as np
import pytest
import torch

import _torch_pack_oracle as oracle
from repro_torch.core import format as fmt, lzss, pipeline
from repro_torch.runtime import trace

from _torch_threads import _one_thread  # noqa: F401

N = 1 << 14  # bytes of a field

CONFIGS = {
    0: lzss.LZSSConfig(symbol_size=2),
    1: lzss.LZSSConfig(symbol_size=2, backend="deflate-full"),
    2: lzss.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=1e-3,
                       lossy_inner="deflate-full"),
}
# raw LZSS at S=4 on a field whose size is not a multiple of S
ODD = lzss.LZSSConfig(symbol_size=4)


def _field(m, n=N, seed=7):
    rng = np.random.default_rng(seed)
    if m == 2:
        x = np.cumsum(rng.normal(size=n // 4)).astype(np.float32)
        x[5] = np.nan  # one outlier at least
        return x
    return np.repeat(rng.integers(0, 6, n), rng.integers(1, 9, n)).astype(np.uint8)[:n]


def _case(m, n=N, seed=7):
    """Case ``m``'s configuration and field; ``"odd"`` is raw LZSS at S=4 on
    ``n + 3`` bytes, not a multiple of S."""
    if m == "odd":
        return ODD, _field(0, n + 3, seed)
    return CONFIGS[m], _field(m, n, seed)


def _batch(m, seed=7):
    """Case ``m``'s configuration and three fields of ragged sizes."""
    cfg = _case(m)[0]
    return cfg, [_case(m, n, seed + i)[1] for i, n in enumerate((N, N // 2, N // 4))]


def _pipeline_containers(cfg, fields):
    """The (B, cap) buffer and totals of ``fields`` straight from the
    pipeline on the CPU, before the host API copies them anywhere."""
    raws = [torch.from_numpy(np.ascontiguousarray(f).view(np.uint8).reshape(-1)) for f in fields]
    nc = lzss._n_chunks(max(r.numel() for r in raws), cfg)
    s, c = cfg.symbol_size, cfg.chunk_symbols
    padded = torch.zeros(len(raws), nc * c * s, dtype=torch.uint8)
    for row, r in zip(padded, raws):
        row[: r.numel()] = r
    symbols = pipeline.pack_symbols(padded.reshape(-1), s).reshape(len(raws), nc, c)
    buf, totals = pipeline.compress_many_chunks(symbols, cfg, [r.numel() for r in raws])
    return buf.numpy(), [int(t) for t in totals]


def _write(entry, m, device="cpu"):
    """One write of case ``m`` through ``entry``; its ``data`` is the
    container, or ``compress_many``'s whole (B, cap) buffer."""
    if entry == "compress":
        cfg, field = _case(m)
        return lzss.compress(field, cfg, device=device)
    cfg, fields = _batch(m)
    return lzss.compress_many(fields, cfg, device=device)


def _blob(m, device="cpu", n=N, seed=7):
    cfg = ODD if m == "odd" else CONFIGS[m]
    field = _field(0 if m == "odd" else m, n, seed)
    return field, lzss.compress(field, cfg, device=device).data


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


@pytest.fixture(params=["cpu-registry", "card-registry"])
def registry(request, monkeypatch):
    """The CPU's default decoders, or the card's (``fused-mono``) as plain
    versions: ``decompress`` takes its whole-container and its section
    routes on both."""
    if request.param == "card-registry":
        monkeypatch.setattr(pipeline, "default_backend", lambda device: "fused-mono")
        monkeypatch.setattr(pipeline, "default_decoder", lambda device: "fused-mono")
    return request.param


def _check_lossy(out, field, eb):
    y = out.view(np.float32)
    ok = ~np.isnan(field)
    assert np.isnan(y[~ok]).all()
    assert np.abs(y[ok].astype(np.float64) - field[ok]).max() <= eb


def _check_back(back, field, m):
    """A decoded case-``m`` field: within the bound for lossy, else exact."""
    if m == 2:
        _check_lossy(back, field, 1e-3)
    else:
        assert np.array_equal(back, field.view(np.uint8))


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("m", [0, 1, 2])
def test_cpu_decompress_returns_what_it_did_and_stages_nothing(tracing, registry, m):
    field, blob = _blob(m)
    tracing.reset()
    out = lzss.decompress(blob, device="cpu")
    c = tracing.snapshot()["counters"]
    h = fmt.parse_header(blob)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.ndim == 1
    assert out.size == h.orig_bytes == field.nbytes and out.flags.writeable
    assert c["pinned_bytes"] == c["pinned_allocs"] == 0
    assert c["bytes_host_copy"] == blob.size  # _validated's one writable copy
    # the batched entry point keeps its pageable copies: the same bytes
    assert np.array_equal(out, lzss.decompress_many([blob], device="cpu")[0])
    if m == 2:
        _check_lossy(out, field, 1e-3)
    else:
        assert np.array_equal(out, field)


def test_cpu_kept_result_survives_later_calls():
    field, blob = _blob(0)
    kept = lzss.decompress(blob, device="cpu")
    before = kept.copy()
    others = [_blob(m, seed=11 + m)[1] for m in (0, 1, 2, 0, 1)]
    for other in others:
        lzss.decompress(other, device="cpu")
    assert np.array_equal(kept, before) and np.array_equal(kept, field)


@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_cpu_compress_returns_what_it_did_and_stages_nothing(tracing, registry, m):
    cfg, field = _case(m)
    tracing.reset()
    res = lzss.compress(field, cfg, device="cpu")
    c = tracing.snapshot()["counters"]
    assert c["pinned_bytes"] == c["pinned_allocs"] == 0
    out = res.data
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.ndim == 1
    assert out.size == res.total_bytes and out.flags.writeable
    assert res.orig_bytes == field.nbytes
    buf, (total,) = _pipeline_containers(cfg, [field])
    assert total == res.total_bytes and np.array_equal(out, buf[0, :total])
    _check_back(lzss.decompress(out, device="cpu"), field, m)


@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_cpu_compress_many_returns_what_it_did_and_stages_nothing(tracing, registry, m):
    cfg, fields = _batch(m)
    tracing.reset()
    batch = lzss.compress_many(fields, cfg, device="cpu")
    c = tracing.snapshot()["counters"]
    assert c["pinned_bytes"] == c["pinned_allocs"] == 0
    out = batch.data
    buf, totals = _pipeline_containers(cfg, fields)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8
    assert out.shape == buf.shape and out.flags.writeable
    assert np.array_equal(out, buf) and batch.total_bytes.tolist() == totals
    assert batch.orig_bytes.tolist() == [f.nbytes for f in fields]
    for field, back in zip(fields, lzss.decompress_many(batch, device="cpu")):
        _check_back(back, field, m)


@pytest.fixture
def staged_writes(monkeypatch, stand_in_allocator):
    """The host API's D2H sites staged through the stand-in's blocks, as on
    a card; the list records the ``pinned`` each site was called with."""
    asked = []
    real = lzss._to_host

    def to_host(t, pinned=False):
        asked.append(pinned)
        return real(t, pinned=True)

    monkeypatch.setattr(lzss, "_to_host", to_host)
    return asked


@pytest.mark.parametrize("entry", ["compress", "compress_many"])
@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_write_staging_site_counts_on_a_stand_in_block(tracing, request, entry, m):
    plain_bytes = _write(entry, m).data
    plain_counts = tracing.snapshot()["counters"]
    # the same call with its container staged through a stand-in block
    asked = request.getfixturevalue("staged_writes")
    tracing.reset()
    res = _write(entry, m)
    out = res.data
    c = tracing.snapshot()["counters"]
    assert asked == [False]  # the CPU's own path asks for no block
    assert out.dtype == np.uint8 and out.flags.writeable and out.shape == plain_bytes.shape
    assert np.array_equal(out, plain_bytes) and not np.shares_memory(out, plain_bytes)
    assert c["pinned_bytes"] == out.size and c["pinned_allocs"] == 1
    if entry == "compress":
        assert out.size == res.total_bytes
    else:
        assert out.size == len(res) * out.shape[1]
    # the same copy, bytes and syncs as the pageable path
    for k in ("bytes_d2h", "bytes_h2d", "bytes_host_copy", "host_syncs"):
        assert c[k] == plain_counts[k], k
    assert plain_counts["pinned_bytes"] == 0


@pytest.mark.parametrize("staging", ["pageable", "stand-in"])
@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_cpu_kept_compress_result_survives_later_calls(request, staging, m):
    if staging == "stand-in":
        request.getfixturevalue("staged_writes")
    cfg, field = _case(m)
    kept = lzss.compress(field, cfg, device="cpu")
    before = kept.data.copy()
    for i, (k, n) in enumerate([(0, N // 2), (1, N * 2), (2, N // 4), ("odd", N), (0, N * 3)]):
        c, f = _case(k, n, seed=11 + i)
        lzss.compress(f, c, device="cpu")
        lzss.compress_many([f, f[: n // 2]], c, device="cpu")
    assert np.array_equal(kept.data, before)
    _check_back(lzss.decompress(kept.data, device="cpu"), field, m)


def _truncated_header(blob):
    return blob[: fmt.HEADER_BYTES - 1]


def _bad_magic(blob):
    b = blob.copy()
    b[0] ^= 0xFF
    return b


def _bad_symbol_size(blob):
    b = blob.copy()
    b[5] = 3
    return b


def _truncated_body(blob):
    return blob[:-1]


CORRUPTIONS = {
    "truncated-header": (_truncated_header, "truncated container"),
    "bad-magic": (_bad_magic, "bad magic"),
    "bad-symbol-size": (_bad_symbol_size, "symbol_size 3"),
    "truncated-body": (_truncated_body, "truncated container: header declares"),
}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_cpu_corrupt_container_raises_naming_the_check(tracing, kind):
    corrupt, words = CORRUPTIONS[kind]
    field, blob = _blob(0)
    tracing.reset()
    with pytest.raises(ValueError, match=words):
        lzss.decompress(corrupt(blob), device="cpu")
    assert tracing.snapshot()["counters"]["bytes_h2d"] == 0  # nothing decoded
    assert np.array_equal(lzss.decompress(blob, device="cpu"), field)


@pytest.fixture
def stand_in_allocator(monkeypatch):
    """A pageable stand-in for torch's caching host allocator, so that the
    page-locked staging sites run on the CPU: each block asked for counts
    as one host allocation."""
    stats = {"num_host_alloc": 0}
    real_empty = torch.empty

    def empty(*args, pin_memory=False, **kw):
        stats["num_host_alloc"] += bool(pin_memory)
        return real_empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: dict(stats))
    return stats


@pytest.mark.parametrize("m", [0, 1, 2])
def test_staging_sites_count_on_a_stand_in_block(tracing, stand_in_allocator, m):
    field, blob = _blob(m)
    tracing.reset()
    host, h, _, _ = lzss._validated(blob, pinned=True)
    assert np.array_equal(host, blob) and host.flags.writeable
    assert not np.shares_memory(host, blob)
    out = lzss._to_host(torch.from_numpy(host.copy()), pinned=True)
    assert np.array_equal(out, blob) and out.dtype == np.uint8
    c = tracing.snapshot()["counters"]
    assert c["pinned_bytes"] == 2 * blob.size and c["pinned_allocs"] == 2
    assert c["bytes_host_copy"] == blob.size and c["bytes_d2h"] == blob.size
    assert c["host_syncs"] == 1
    assert h.orig_bytes == field.nbytes


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the H100; see README)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_card_result_is_page_locked_and_equals_the_cpu_path(cuda, m):
    n = N + 3 if m == "odd" else N
    field, blob = _blob(m, device=cuda, n=n)
    assert np.array_equal(blob, _blob(m, n=n)[1])  # the card's container is the CPU's
    out = lzss.decompress(blob)
    assert torch.from_numpy(out).is_pinned()
    assert out.dtype == np.uint8 and out.size == fmt.parse_header(blob).orig_bytes
    assert out.flags.writeable
    assert np.array_equal(out, lzss.decompress(blob, device="cpu"))
    if m != 2:
        assert np.array_equal(out, field)


@pytest.mark.gpu
def test_card_kept_result_is_not_overwritten_by_later_calls(cuda):
    field, blob = _blob(0, device=cuda)
    kept = lzss.decompress(blob)
    others = [_blob(m, device=cuda, seed=11 + m)[1] for m in (0, 1, 2)]
    for i in range(20):
        lzss.decompress(others[i % 3])
    assert np.array_equal(kept, field)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [0, 1, 2])
def test_card_steady_state_allocates_no_block(cuda, m):
    _, blob = _blob(m, device=cuda)
    for _ in range(3):  # warm: the kernels, the allocator's blocks
        lzss.decompress(blob)
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    try:
        for _ in range(10):
            out = lzss.decompress(blob)
            del out
        c = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    orig = fmt.parse_header(blob).orig_bytes
    assert c["pinned_allocs"] == 0
    assert c["pinned_bytes"] == 10 * (blob.size + orig)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_card_corrupt_container_raises_before_any_h2d(cuda, kind):
    corrupt, words = CORRUPTIONS[kind]
    field, blob = _blob(0, device=cuda)
    trace.reset()
    trace.enable()
    try:
        with pytest.raises(ValueError, match=words):
            lzss.decompress(corrupt(blob))
        c = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert c["bytes_h2d"] == 0 and c["host_syncs"] == 0
    assert np.array_equal(lzss.decompress(blob), field)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["compress", "compress_many"])
@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_card_write_result_is_page_locked_and_equals_the_cpu_path(cuda, entry, m):
    res = _write(entry, m, device=cuda)
    out = res.data
    assert torch.from_numpy(out).is_pinned()
    assert out.dtype == np.uint8 and out.flags.writeable
    if entry == "compress":
        assert out.size == res.total_bytes
    cpu_out = _write(entry, m).data
    assert out.shape == cpu_out.shape and np.array_equal(out, cpu_out)


# the container headers one write of case ``m`` stages, each from a
# page-locked block: a raw container's one; a lossy container's inner
# container's and its own
HEADERS = {0: 1, 1: 1, 2: 2, "odd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["compress", "compress_many"])
@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_card_write_steady_state_allocates_no_block(cuda, entry, m):
    for _ in range(3):  # warm: the kernels, the allocator's blocks
        _write(entry, m, device=cuda)
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    try:
        # each result is dropped before the next call, as the warm-up's were
        sizes = [_write(entry, m, device=cuda).data.size for _ in range(10)]
        c = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    buffers = 1 if entry == "compress" else len(_batch(m)[1])
    assert c["pinned_allocs"] == 0
    assert c["pinned_bytes"] == sum(sizes) + 10 * buffers * HEADERS[m] * fmt.HEADER_BYTES


@pytest.mark.gpu
@pytest.mark.parametrize("m", [0, 1, 2, "odd"])
def test_card_kept_compress_result_survives_later_calls(cuda, m):
    cfg, field = _case(m)
    kept = lzss.compress(field, cfg)
    before = kept.data.copy()
    later = [(m, N), (0, N // 2), (1, N * 2), (2, N // 4), ("odd", N)]
    for i in range(20):  # every size class again, and the kept one's
        k, n = later[i % len(later)]
        c, f = _case(k, n, seed=11 + i)
        if i % 2:
            lzss.compress_many([f, f[: n // 2]], c)
        else:
            lzss.compress(f, c)
    assert np.array_equal(kept.data, before)
    _check_back(lzss.decompress(kept.data), field, m)


def _synchronising_calls(fn) -> int:
    """Warnings of ``torch.cuda.set_sync_debug_mode("warn")`` raised from
    the program's own lines while ``fn`` runs."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(1 for w in ws if "synchroniz" in str(w.message).lower()
               and "repro_torch" in w.filename)


@pytest.mark.gpu
def test_card_chunked_field_is_one_batch_of_the_per_buffer_loops_bytes(cuda):
    """A 50 MB field of u16 codes on the card cut into its 763 64 KiB
    chunks, the last one short, as nvCOMP's batched API takes them: the
    batch's bytes are those of the per-buffer loop on the card, and its
    host syncs the card's own count."""
    n = 50_000_000
    rng = np.random.default_rng(5)
    codes = (np.cumsum(rng.integers(-2, 3, n // 2)) % 64 + 32740).astype(np.int16)
    field = torch.from_numpy(codes).to(cuda)
    bufs = [field[a // 2 : min(a + 65536, n) // 2] for a in range(0, n, 65536)]
    assert len(bufs) == 763 and bufs[-1].numel() < bufs[0].numel()
    cfg = lzss.LZSSConfig(symbol_size=2)
    lzss.compress_many(bufs, cfg)  # warm: the kernel's build, the host blocks
    torch.cuda.synchronize()
    got = {}
    trace.reset()
    trace.enable()
    try:
        reported = _synchronising_calls(lambda: got.update(batch=lzss.compress_many(bufs, cfg)))
        c = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert c["host_syncs"] == reported == 2  # the totals' read and the batch's D2H
    assert c["rows_packed_alone"] == 0
    data, totals, sizes = oracle.compress_many(bufs, cfg, cuda)
    batch = got["batch"]
    assert batch.orig_bytes.tolist() == sizes
    assert batch.total_bytes.tolist() == totals and np.array_equal(batch.data, data)
