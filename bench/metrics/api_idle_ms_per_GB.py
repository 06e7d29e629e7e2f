"""Host API layer: the device idle of the traced window that falls under
the host API's spans (``lzss.*``, ``pipeline.*``: the innermost program
span open over each part of an idle gap, ``bench/spans.py``), in
milliseconds per GB (1e9) of field bytes."""

from bench import spans

prepare = spans.prepare


def snapshot(run):
    return spans.snapshot(run, __name__)


def read(run, variant):
    if variant != run.direction:
        return None
    split = spans.idle_split(run)
    if split is None:
        return None
    s = sum(v for k, v in split.items() if k and k.startswith(spans.API))
    return spans.per_gb(run, s * 1e3)
