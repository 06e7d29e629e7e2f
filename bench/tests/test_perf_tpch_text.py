"""The TPC-H ``l_comment`` generator against the clauses it follows, at the
tests' small size: the pool is sentences of the pseudo-text grammar with
its word lists and weights (Clause 4.2.2), a comment is a substring of it
of a length uniform on [10, 43] (Clause 4.2.3), the chars are cut into the
configuration's 16 equal slices, and the seed only rotates them."""

from __future__ import annotations

import collections
import math
import re

import pytest
import torch

from bench import manifest
from bench.gen import tpch_text as text

ELEMENTS = 8_000  # bytes a slice: a pool of 1 MB
SEEDS = [0, 2**31 + 12345, 3_000_000_001, 2**63 + 5]


@pytest.fixture(scope="module")
def full():
    return manifest.config(manifest.load(), "tpch-lineitem-comment-u8")


@pytest.fixture(scope="module")
def spec(full):
    return text.small(full["data"], elements=ELEMENTS, fields=full["data"]["slices"])


@pytest.fixture(scope="module")
def pool(spec):
    return text.pool(spec, "cpu")


def _words(cls):
    return "|".join(re.escape(w) for w, _ in sorted(text.WORDS[cls], key=lambda e: -len(e[0])))


def _grammar_re():
    n, j, d = _words("noun"), _words("adjective"), _words("adverb")
    v, x, p = _words("verb"), _words("auxiliary"), _words("preposition")
    np_ = f"(?:(?:{d}) (?:{j}) |(?:{j}), (?:{j}) |(?:{j}) )?(?:{n})"
    vp = f"(?:(?:{x}) )?(?:{v})(?: (?:{d}))?"
    pp = f"(?:{p}) the {np_}"
    body = f"{np_} (?:{vp}(?: {pp}| {np_})?|{pp} {vp} (?:{np_}|{pp}))"
    return re.compile(f"(?:{body}(?:{_words('terminator')}) )*")


def test_the_configuration_is_sf10_l_comment_at_s1(full, spec):
    d = full["data"]
    assert d["rows"] == 59_986_052 and d["scale_factor"] == 10 and d["slices"] == 16
    assert d["length"] == [10, 43] and d["form"] == "u8" and d["pool_bytes"] == 300 << 20
    assert full["codec"] == {"symbol_size": 1, "window": 128, "chunk_symbols": 2048}
    assert full["reduced"] == ["slices"]
    assert spec["slices"] == 16 and spec["scale_factor"] == 0.01


def test_the_pool_is_sentences_of_the_grammar(spec, pool):
    assert pool.numel() == spec["pool_bytes"]
    s = bytes(pool.tolist()).decode("ascii")
    # up to the last whole sentence, cut where a terminator meets a space
    end = max(s.rfind(t + " ") + len(t) + 1 for t in text.TERMINATORS)
    assert end > len(s) - 200
    assert _grammar_re().fullmatch(s[:end]) is not None
    assert "  " not in s and s[0] != " "


def test_every_word_is_from_the_lists(pool):
    s = bytes(pool.tolist()).decode("ascii")
    known = {"the"} | {t for ws in text.WORDS.values() for w, _ in ws for t in w.split()}
    tokens = re.split(r"[ ,.;:?!]|--", s)[:-1]  # the last one may be cut
    assert {t for t in tokens if t} <= known
    assert set(s) <= set("".join(known)) | set(" ,") | set("".join(text.TERMINATORS))


@pytest.mark.parametrize("cls", ["noun", "verb", "adjective", "adverb", "preposition"])
def test_the_words_follow_their_weights(pool, cls):
    s = bytes(pool.tolist()).decode("ascii")
    stripped = re.sub(r"[,.;:?!]|--", "", s)
    counts = collections.Counter()
    words = text.WORDS[cls]
    for w, _ in words:
        counts[w] = len(re.findall(rf"(?<![\w-]){re.escape(w)}(?![\w-])", stripped))
    if cls == "preposition":  # "to" and "of" are also inside longer entries
        for w in ("to", "of"):
            counts[w] -= sum(counts[x] for x, _ in words if x != w and x.endswith(" " + w))
        counts["to"] -= sum(stripped.count(x) for x, _ in text.WORDS["auxiliary"]
                            if x.endswith(" to"))
    total_w = sum(k for _, k in words)
    seen = sum(counts[w] for w, _ in words)
    assert seen > 1000
    for w, k in words:
        want = seen * k / total_w
        assert abs(counts[w] - want) <= 5 * math.sqrt(want) + 2, (w, counts[w], want)


def test_row_lengths_and_offsets(spec, pool):
    length, offset = text.rows(spec, pool.numel(), "cpu")
    assert length.numel() == spec["rows"]
    assert int(length.min()) == 10 and int(length.max()) == 43
    assert abs(float(length.double().mean()) - 26.5) < 0.5
    assert int(offset.min()) >= 0 and bool((offset + length <= pool.numel()).all())
    chars = text.chars(spec, "cpu")
    parts = [pool[o : o + n] for o, n in zip(offset.tolist(), length.tolist())]
    assert torch.equal(chars, torch.cat(parts))


@pytest.mark.parametrize("seed", SEEDS)
def test_sixteen_equal_slices_and_the_seed_only_rotates(spec, seed):
    a = text.make(spec, seed, "cpu")
    chars = text.chars(spec, "cpu")
    total = chars.numel()
    assert a.dtype == torch.uint8 and a.shape == (16, total // 16)
    assert torch.equal(a, text.make(spec, seed, "cpu"))  # the same seed, the same bytes
    s = text.shift(spec, seed, total)
    assert torch.equal(a.reshape(-1), torch.roll(chars, -s)[: total // 16 * 16])


def test_other_seeds_other_bytes_same_text(spec):
    a, b = text.make(spec, 7, "cpu"), text.make(spec, 8, "cpu")
    assert not torch.equal(a, b)
    assert abs(torch.bincount(a.reshape(-1), minlength=256)
               - torch.bincount(b.reshape(-1), minlength=256)).sum() <= 2 * 15


def test_another_pool_seed_another_pool(spec):
    other = dict(spec, pool_seed=spec["pool_seed"] + 1)
    assert not torch.equal(text.pool(spec, "cpu"), text.pool(other, "cpu"))
    with pytest.raises(ValueError):
        text.make(dict(spec, form="i32"), 3, "cpu")
