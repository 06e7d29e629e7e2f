"""TPC-H ``l_comment`` text at S=1 through the port's host API.

The text is ``bench/gen/tpch_text.py``'s at a few KiB to 64 KiB, and the
codec settings are the configuration's (``tpch-lineitem-comment-u8``: S=1,
W=128, C=2048).  Each case holds ``lzss.compress`` to the benchmark's own
plain decoder (``bench/reference/gplz.py``) and to the plain ``torch``
backend byte for byte, and the ``symbol_bytes`` counter to the symbol rows
the pack writes (4 bytes a padded symbol: 4, 2 and 1 a padded field byte
at S=1, 2 and 4).  The control of the lossless guarantee has to fail.

The ``gpu`` cases run the same checks through ``fused-mono`` on the card
and skip without one:

    PYTHONPATH=.:src python -m pytest -m gpu tests/test_torch_text_s1.py
"""

import numpy as np
import pytest
import torch

from bench import manifest
from bench.gen import tpch_text
from bench.reference import gplz, lossless
from repro_torch.core import lzss
from repro_torch.runtime import trace

from _torch_threads import _one_thread  # noqa: F401

CONFIG = manifest.config(manifest.load(), "tpch-lineitem-comment-u8")
CODEC = CONFIG["codec"]
SEEDS = [0, 2**31 + 12345, 3_000_000_001]
SIZES = [3000, 16384, 65536]


@pytest.fixture(scope="module")
def texts():
    """seed -> 64 KiB or more of the generator's text, one slice."""
    spec = tpch_text.small(CONFIG["data"], elements=72 << 10, fields=1)
    out = {}
    for seed in SEEDS:
        out[seed] = tpch_text.make(spec, seed, "cpu")[0]
        assert out[seed].numel() >= 65536
    return out


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def _cfg(s=1, **kw):
    return lzss.LZSSConfig(**dict(CODEC, symbol_size=s), **kw)


def _padded_bytes(n, s):
    """Bytes of ``n`` field bytes padded to whole chunks of the codec."""
    c = CODEC["chunk_symbols"]
    symbols = -(-n // s)
    return -(-symbols // c) * c * s


def _check_text(text, device, backend):
    """The S=1 container of ``text`` through ``backend`` on ``device``:
    decodes to ``text``, equals the plain backend's, has S=1 in its header."""
    res = lzss.compress(text.to(device), _cfg(backend=backend), device=device)
    blob = np.asarray(res.data)
    assert gplz.parse_header(blob)["S"] == 1
    assert res.orig_bytes == text.numel() and res.total_bytes == blob.size
    assert torch.equal(gplz.decode(blob, "cpu"), text)
    plain = lzss.compress(text.to(device), _cfg(backend="torch"), device=device)
    assert np.array_equal(blob, np.asarray(plain.data))
    return res


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_s1_text_decodes_and_equals_the_plain_backend(texts, seed, size):
    res = _check_text(texts[seed][:size], "cpu", "auto")
    assert res.ratio > 1.0  # the grammar's words repeat inside the window


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("s", [1, 2, 4])
def test_symbol_bytes_counts_four_bytes_a_padded_symbol(texts, tracing, s, size):
    text = texts[SEEDS[0]][:size]
    lzss.compress(text, _cfg(s), device="cpu")
    padded = _padded_bytes(size, s)
    got = tracing.snapshot()["counters"]["symbol_bytes"]
    assert got == 4 * (padded // s) == (4 // s) * padded
    tracing.reset()
    lzss.compress_many([text, text[: size // 2]], _cfg(s), device="cpu")
    assert tracing.snapshot()["counters"]["symbol_bytes"] == 2 * got  # a row each, one width


def _round_trip(data):
    return gplz.decode(np.asarray(lzss.compress(data, _cfg(), device="cpu").data), "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_comparison(texts, seed):
    text, spec = texts[seed], CONFIG["guarantee"]
    assert lossless.compare(text, _round_trip(text), spec)["mismatched_bytes"] == 0
    broken = lossless.control(text[None], spec, CODEC["symbol_size"])[0]
    back = _round_trip(broken)
    assert torch.equal(back, broken)  # the program stores what it is handed
    assert lossless.compare(text, back, spec)["mismatched_bytes"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the H100; see README)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_s1_text_through_fused_mono_on_the_card(cuda, texts, tracing, seed):
    spec = tpch_text.small(CONFIG["data"], elements=4 << 20, fields=2)
    fields = tpch_text.make(spec, seed, cuda)
    for k in range(fields.shape[0]):
        tracing.reset()
        res = _check_text(fields[k].cpu(), cuda, "fused-mono")
        counters = tracing.snapshot()["counters"]
        # this call's pack and the plain backend's: the same rows twice
        assert counters["symbol_bytes"] == 2 * 4 * _padded_bytes(fields.shape[1], 1)
        assert res.ratio > 1.0
    for size in SIZES:
        _check_text(texts[seed][:size], cuda, "fused-mono")
    broken = lossless.control(fields, CONFIG["guarantee"], 1)
    res = lzss.compress(broken[0], _cfg(backend="fused-mono"), device=cuda)
    back = gplz.decode(np.asarray(res.data), cuda)
    assert lossless.compare(fields[0], back, CONFIG["guarantee"])["mismatched_bytes"] > 0
