"""What both directions of the host API share: the fields as the program
is handed them, typed, one ``LZSSConfig`` a field, and the cut of the
fields into fixed-size buffers that the batched entry points take."""

from __future__ import annotations

import torch

_DTYPES = {"f32": torch.float32, "quant_codes": torch.int16, "i32": torch.int32,
           "u8": torch.uint8}


def typed_fields(run) -> list:
    """Each field as a GPU application holds it: a flat typed tensor."""
    dtype = _DTYPES[run.config["data"]["form"]]
    return [run.program_fields[k].view(dtype) for k in range(run.program_fields.shape[0])]


def configs(run, lzss) -> list:
    """One ``LZSSConfig`` a field: the configuration's codec settings and
    what the guarantee derives from the field (the lossy bound)."""
    codec = run.config["codec"]
    spec = run.config["guarantee"]
    return [
        lzss.LZSSConfig(**codec, **run.guarantee.codec_overrides(run.fields[k], spec))
        for k in range(run.fields.shape[0])
    ]


def batches(run) -> list:
    """The items of a batched op, one a field: the field cut from its start
    into chunks of the traffic's ``buffer_bytes`` (the last one shorter),
    all of them one call, as nvCOMP's batched API takes an input's chunks.
    An item is ``(field, [(start, end) byte range of each chunk])``."""
    size = run.traffic["buffer_bytes"]
    n = run.program_fields.shape[1]
    width = _DTYPES[run.config["data"]["form"]].itemsize
    if size % width:
        raise ValueError(f"buffer_bytes {size} is not a whole number of {width}-byte elements")
    cuts = [(a, min(a + size, n)) for a in range(0, n, size)]
    return [(k, cuts) for k in range(run.program_fields.shape[0])]


def buffers(typed: torch.Tensor, ranges) -> list:
    """Views (no copies) of a typed field, one a byte range."""
    w = typed.element_size()
    return [typed[a // w : b // w] for a, b in ranges]


def small_batches(traffic: dict) -> dict:
    """A batched traffic mix at the tests' small sizes: chunks of 1,536
    bytes, so that a field of a few KiB makes several and a short last one."""
    return dict(traffic, buffer_bytes=1536)
