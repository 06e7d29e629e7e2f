"""Model facade: abstract shapes + concrete init/batch helpers.

The abstract forms are tensors on ``device="meta"``: they carry shapes and
dtypes and allocate nothing (``abstract_params`` of deepseek-v2-236b is a
236 B-parameter module of meta tensors).  Audio/VLM archs receive
precomputed frame/patch embeddings from the modality frontend stub; text
archs receive token ids.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import common, transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy

__all__ = [
    "abstract_cache", "abstract_paged_cache", "abstract_params", "init_params", "input_specs",
    "make_batch", "param_axes", "params_from_numpy", "params_to_numpy",
    "uses_embedding_frontend",
]

META = torch.device("meta")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> transformer.Transformer:
    """The model with weights drawn from a generator seeded with ``seed``
    on ``device`` (so one seed gives other weights on cuda than on cpu)."""
    dev = common.resolve_device(device)
    model, _ = transformer.init_params(cfg, common.generator(seed, dev), dev)
    return model


def abstract_params(cfg: ModelConfig) -> transformer.Transformer:
    return transformer.init_params(cfg, None, META)[0]


def param_axes(cfg: ModelConfig) -> dict:
    """``{state_dict key: logical axes}``; a layer's keys (``layers.3.attn.wq``)
    carry the axes of the one layer, without the reference's ``"layers"``."""
    return abstract_params(cfg).param_axes()


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int):
    return transformer.init_cache(cfg, batch, seq_len, device=META)


def abstract_paged_cache(cfg: ModelConfig, batch: int, seq_len: int, *, block_tokens: int,
                         pool_blocks=None):
    return transformer.init_paged_cache(cfg, batch, seq_len, block_tokens=block_tokens,
                                        pool_blocks=pool_blocks, device=META)


def uses_embedding_frontend(cfg: ModelConfig) -> bool:
    return cfg.frontend in ("audio_stub", "vision_stub")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for the batch of a given (arch x shape) cell."""
    b, t = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        if uses_embedding_frontend(cfg):
            # frontend stub supplies frame/patch embeddings; labels are the
            # (audio-code / VQ / text) token targets in the shared vocab.
            return {"embeds": spec((b, t, cfg.d_model), common.dtype_of(cfg)),
                    "labels": spec((b, t), i32)}
        return {"tokens": spec((b, t), i32)}
    # decode: one new token against a seq_len cache
    return {"tokens": spec((b,), i32), "pos": spec((), i32)}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, device="cuda") -> dict:
    """Concrete synthetic batch matching input_specs, drawn on ``device``."""
    dev = common.resolve_device(device)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        g = common.generator(seed, dev)
        if s.dtype == torch.int32 and name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab_size, s.shape, generator=g, dtype=torch.int32,
                                      device=dev)
        elif s.dtype == torch.int32:
            out[name] = torch.zeros(s.shape, dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(s.shape, generator=g, dtype=torch.float32,
                                    device=dev).to(s.dtype)
    return out
