"""What both directions of the host API share: the fields as the program
is handed them, typed, and one ``LZSSConfig`` a field."""

from __future__ import annotations

import torch

_DTYPES = {"f32": torch.float32, "quant_codes": torch.int16}


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
