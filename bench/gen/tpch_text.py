"""TPC-H ``lineitem``'s ``l_comment`` text, made on the device from the seed.

The TPC-H Standard Specification v3.0.1 makes every comment column a *text
string[min, max]* (Clause 4.2.2): a substring of a pool of pseudo-text, at
a random offset and of a length uniform on [min, max].  ``L_COMMENT`` is a
text string[10, 43] (Clause 4.2.3), so a comment is 26.5 bytes on average,
and scale factor 10 has 59,986,052 of them (Clause 4.2.5).

The pool (``pool_bytes``, 300 MB) is sentences of the spec's pseudo-text
grammar (Clause 4.2.2), each production and word drawn by its weight
(``GRAMMAR``, ``NOUN_PHRASE``, ``VERB_PHRASE``, ``WORDS``):

    sentence              noun-phrase verb-phrase terminator
                        | noun-phrase verb-phrase prep-phrase terminator
                        | noun-phrase verb-phrase noun-phrase terminator
                        | noun-phrase prep-phrase verb-phrase noun-phrase terminator
                        | noun-phrase prep-phrase verb-phrase prep-phrase terminator
    noun-phrase           noun | adjective noun | adjective, adjective noun
                        | adverb adjective noun
    verb-phrase           verb | auxiliary verb | verb adverb | auxiliary verb adverb
    prep-phrase           preposition the noun-phrase

Words are separated by single spaces, a terminator follows its word with
none, and sentences are separated by single spaces.

A column store holds ``l_comment`` as Arrow and cuDF do: a chars buffer, the
comments end to end, and an int32 offsets child (not made here: it is an
int32 column).  ``make`` returns the chars buffer rotated cyclically by the
run's seed and cut into ``slices`` equal slices, the (total mod slices)
bytes past the last slice dropped.  So every seed gives the same work on
other bytes.  The pool and the rows are drawn from ``torch.Generator``s on
the device seeded from ``pool_seed``, each quantity from its own; the bytes
differ from ``dbgen``'s (another generator), the distributions are the same.
"""

from __future__ import annotations

import random

import torch

# (production, weight); a production is its word classes in order, "J," an
# adjective followed by a comma
GRAMMAR = ((("N", "V", "T"), 3), (("N", "V", "P", "T"), 3), (("N", "V", "N", "T"), 3),
           (("N", "P", "V", "N", "T"), 1), (("N", "P", "V", "P", "T"), 1))
NOUN_PHRASE = ((("noun",), 10), (("adjective", "noun"), 20),
               (("adjective,", "adjective", "noun"), 10), (("adverb", "adjective", "noun"), 50))
VERB_PHRASE = ((("verb",), 30), (("auxiliary", "verb"), 1), (("verb", "adverb"), 40),
               (("auxiliary", "verb", "adverb"), 1))


def _ones(*words):
    return tuple((w, 1) for w in words)


WORDS = {
    "noun": (("packages", 40), ("requests", 40), ("accounts", 40), ("deposits", 40),
             ("foxes", 20), ("ideas", 20), ("theodolites", 20), ("pinto beans", 20),
             ("instructions", 20), ("dependencies", 10), ("excuses", 10), ("platelets", 10),
             ("asymptotes", 10), ("courts", 5), ("dolphins", 5))
            + _ones("multipliers", "sauternes", "warthogs", "frets", "dinos", "attainments",
                    "somas", "Tiresias", "patterns", "forges", "braids", "hockey players",
                    "frays", "warhorses", "dugouts", "notornis", "epitaphs", "pearls", "tithes",
                    "waters", "orbits", "gifts", "sheaves", "depths", "sentiments", "decoys",
                    "realms", "pains", "grouches", "escapades"),
    "verb": (("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20), ("haggle", 20),
             ("nag", 10), ("use", 10), ("boost", 10), ("affix", 5), ("detect", 5),
             ("integrate", 5))
            + _ones("maintain", "nod", "was", "lose", "sublate", "solve", "thrash", "promise",
                    "engage", "hinder", "print", "x-ray", "breach", "eat", "grow", "impress",
                    "mold", "poach", "serve", "run", "dazzle", "snooze", "doze", "unwind",
                    "kindle", "play", "hang", "believe", "doubt"),
    "adjective": (("special", 20), ("pending", 20), ("unusual", 20), ("express", 20))
                 + _ones("furious", "sly", "careful", "blithe", "quick", "fluffy", "slow",
                         "quiet", "ruthless", "thin", "close", "dogged", "daring", "brave",
                         "stealthy", "permanent", "enticing", "idle", "busy")
                 + (("regular", 50), ("final", 40), ("ironic", 40), ("even", 30), ("bold", 20),
                    ("silent", 10)),
    "adverb": _ones("sometimes", "always", "never")
              + (("furiously", 50), ("slyly", 50), ("carefully", 50), ("blithely", 40),
                 ("quickly", 30), ("fluffily", 20))
              + _ones("slowly", "quietly", "ruthlessly", "thinly", "closely", "doggedly",
                      "daringly", "bravely", "stealthily", "permanently", "enticingly", "idly",
                      "busily", "regularly", "finally", "ironically", "evenly", "boldly",
                      "silently"),
    "preposition": (("about", 50), ("above", 50), ("according to", 50), ("across", 50),
                    ("after", 50), ("against", 40), ("along", 40), ("alongside of", 30),
                    ("among", 30), ("around", 20), ("at", 10))
                   + _ones("atop", "before", "behind", "beneath", "beside", "besides",
                           "between", "beyond", "by", "despite", "during", "except", "for",
                           "from", "in place of", "inside", "instead of", "into", "near", "of",
                           "on", "outside", "over", "past", "since", "through", "throughout",
                           "to", "toward", "under", "until", "up", "upon", "without", "with",
                           "within"),
    "auxiliary": _ones("do", "may", "might", "shall", "will", "would", "can", "could",
                       "should", "ought to", "must", "will have to", "shall have to",
                       "could have to", "should have to", "must have to", "need to", "try to"),
    "terminator": ((".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1)),
}
TERMINATORS = tuple(w for w, _ in WORDS["terminator"])

# a word slot's class: what its words are, each as it is written into the pool
_CLASSES = ("", "noun", "verb", "adjective", "adjective,", "adverb", "auxiliary",
            "preposition", "the", "terminator")
_SLOTS = 5  # word slots of a phrase: a prepositional phrase's two and a noun phrase's three
_KINDS = ("", "N", "V", "P", "T")  # a sentence's phrase slots
_PHRASES = max(len(p) for p, _ in GRAMMAR)
_MIX = 0x9E3779B97F4A7C15
# the drawn quantities, each its own generator (its index is its stream)
_DRAWS = ("pool", "length", "offset")
_SENTENCES = 1 << 20  # sentences drawn at once
_ROWS = 1 << 22  # rows gathered at once


def _generator(spec, name, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(spec["pool_seed"]) * _MIX + _DRAWS.index(name) + 1) % (1 << 63))
    return gen


def _entries(cls):
    """(text as written into the pool, weight) of each word of a class: a
    space before every word but a terminator."""
    if cls == "":
        return (("", 1),)
    if cls == "the":
        return ((" the", 1),)
    if cls == "terminator":
        return WORDS[cls]
    base = WORDS[cls.rstrip(",")]
    return tuple((" " + w + ("," if cls.endswith(",") else ""), k) for w, k in base)


class _Tables:
    """The grammar as lookup tables on ``device``."""

    def __init__(self, device):
        cls_id = {c: k for k, c in enumerate(_CLASSES)}
        entries = [_entries(c) for c in _CLASSES]
        words = [w.encode() for e in entries for w, _ in e]
        weights = torch.tensor([k for e in entries for _, k in e], dtype=torch.int64)
        self.ends = torch.cumsum(weights, 0).to(device)  # a word's cumulative weight
        totals = torch.tensor([sum(k for _, k in e) for e in entries], dtype=torch.int64)
        self.class_total = totals.to(device)
        self.class_base = (torch.cumsum(totals, 0) - totals).to(device)
        self.length = torch.tensor([len(w) for w in words], dtype=torch.int64, device=device)
        text = torch.zeros(len(words), max(map(len, words)), dtype=torch.uint8)
        for k, w in enumerate(words):
            text[k, : len(w)] = torch.tensor(list(w), dtype=torch.uint8)
        self.text = text.to(device)

        np_forms = [[cls_id[w] for w in p] for p, _ in NOUN_PHRASE]
        vp_forms = [[cls_id[w] for w in p] for p, _ in VERB_PHRASE]
        # slot[kind, noun-phrase form, verb-phrase form] -> a phrase's word classes
        slot = torch.zeros(len(_KINDS), len(np_forms), len(vp_forms), _SLOTS, dtype=torch.int64)
        for a, npf in enumerate(np_forms):
            for b, vpf in enumerate(vp_forms):
                for kind, seq in (("N", npf), ("V", vpf),
                                  ("P", [cls_id["preposition"], cls_id["the"]] + npf),
                                  ("T", [cls_id["terminator"]])):
                    slot[_KINDS.index(kind), a, b, : len(seq)] = torch.tensor(seq)
        self.slot = slot.to(device)
        self.grammar = torch.tensor([[_KINDS.index(k) for k in p] + [0] * (_PHRASES - len(p))
                                     for p, _ in GRAMMAR], dtype=torch.int64, device=device)
        self.grammar_ends = _ends(GRAMMAR, device)
        self.np_ends, self.vp_ends = _ends(NOUN_PHRASE, device), _ends(VERB_PHRASE, device)


def _ends(weighted, device) -> torch.Tensor:
    return torch.cumsum(torch.tensor([k for _, k in weighted], dtype=torch.int64), 0).to(device)


def _pick(ends, n, gen) -> torch.Tensor:
    """Indices drawn by weight: ``ends`` the cumulative weights."""
    r = torch.randint(0, int(ends[-1]), n, generator=gen, device=ends.device)
    return torch.searchsorted(ends, r, right=True)


def _sentences(t: _Tables, m: int, gen) -> torch.Tensor:
    """The bytes of ``m`` sentences, each after a space."""
    form = t.grammar[_pick(t.grammar_ends, (m,), gen)]  # (m, phrases) kinds
    npf = _pick(t.np_ends, (m, _PHRASES), gen)
    vpf = _pick(t.vp_ends, (m, _PHRASES), gen)
    cls = t.slot[form, npf, vpf].reshape(-1)  # every word slot in order
    # a word of its class by weight: a draw below 2**40 modulo the class's
    # total weight (a few hundred at most: a bias under 1e-9)
    r = torch.randint(0, 1 << 40, cls.shape, generator=gen, device=cls.device)
    word = torch.searchsorted(t.ends, t.class_base[cls] + r % t.class_total[cls], right=True)
    owner, within = _runs(t.length[word])
    return t.text[word[owner], within]


def _runs(length) -> tuple:
    """(owner, within) of each byte of runs of ``length`` bytes laid end to
    end: the run it is in, and its place in that run."""
    owner = torch.repeat_interleave(torch.arange(length.numel(), device=length.device), length)
    start = torch.cumsum(length, 0) - length
    return owner, torch.arange(owner.numel(), device=length.device) - start[owner]


def pool(spec: dict, device) -> torch.Tensor:
    """(pool_bytes,) uint8: the grammar's sentences, separated by single
    spaces, cut at ``pool_bytes``."""
    t = _Tables(device)
    gen = _generator(spec, "pool", device)
    n = int(spec["pool_bytes"])
    out = torch.empty(n + 1, dtype=torch.uint8, device=device)  # + the first sentence's space
    filled = 0
    while filled < n + 1:
        # a sentence is at least 11 bytes with its space, about 59 on average
        part = _sentences(t, min(_SENTENCES, (n + 1 - filled) // 48 + 1), gen)
        k = min(part.numel(), n + 1 - filled)
        out[filled : filled + k] = part[:k]
        filled += k
    return out[1:]


def rows(spec: dict, n_pool: int, device) -> tuple:
    """(length, offset) of each comment, (rows,) int64 each: the length
    uniform on ``length`` [min, max], the offset uniform on [0, pool bytes
    - length]."""
    lo, hi = spec["length"]
    n = int(spec["rows"])
    length = torch.randint(lo, hi + 1, (n,), generator=_generator(spec, "length", device),
                           device=device)
    u = torch.rand(n, generator=_generator(spec, "offset", device), dtype=torch.float64,
                   device=device)
    offset = (u * (n_pool - length + 1)).floor().to(torch.int64)
    return length, offset


def chars(spec: dict, device) -> torch.Tensor:
    """The column's chars buffer: every comment's bytes, rows in order."""
    text = pool(spec, device)
    length, offset = rows(spec, text.numel(), device)
    out = torch.empty(int(length.sum()), dtype=torch.uint8, device=device)
    at = 0
    for a in range(0, length.numel(), _ROWS):
        owner, within = _runs(length[a : a + _ROWS])
        part = text[offset[a : a + _ROWS][owner] + within]
        out[at : at + part.numel()] = part
        at += part.numel()
    return out


def shift(spec: dict, seed: int, total: int) -> int:
    """The seed's cyclic rotation of the chars buffer (to the left)."""
    return random.Random(int(seed)).randrange(total)


def make(spec: dict, seed: int, device) -> torch.Tensor:
    """(slices, total // slices) uint8: the chars buffer rotated left by the
    seed's shift, cut into equal slices."""
    if spec["form"] != "u8":
        raise ValueError(f"tpch_text stores text bytes, not {spec['form']!r}")
    buf = chars(spec, device)
    total, k = buf.numel(), int(spec["slices"])
    if total < k:
        raise ValueError(f"{total} bytes do not make {k} slices")
    s, n = shift(spec, seed, total), total // k * k
    out = torch.empty(n, dtype=torch.uint8, device=device)
    head = min(total - s, n)
    out[:head] = buf[s : s + head]
    out[head:] = buf[: n - head]
    return out.view(k, n // k)


def small(spec: dict, elements: int, fields: int) -> dict:
    """The spec at the tests' sizes: ``fields`` slices of about ``elements``
    bytes from a pool of 64 KiB or more, at SF 0.01."""
    n = max(1, round(elements * fields / 26.5))
    return dict(spec, scale_factor=0.01, rows=n, slices=int(fields),
                pool_bytes=max(1 << 16, 8 * elements * fields))
