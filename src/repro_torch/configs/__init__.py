"""Config registry: ``get_config("<arch>")`` and the 40-cell (arch x shape) matrix."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    chameleon_34b,
    deepseek_7b,
    deepseek_v2_236b,
    hymba_1_5b,
    llama3_2_1b,
    llama3_8b,
    llama4_scout_17b_a16e,
    mamba2_2_7b,
    musicgen_medium,
    phi3_medium_14b,
)
from repro_torch.configs.base import (
    SHAPES,
    CompressionConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        deepseek_7b,
        llama3_8b,
        phi3_medium_14b,
        llama3_2_1b,
        hymba_1_5b,
        deepseek_v2_236b,
        llama4_scout_17b_a16e,
        mamba2_2_7b,
        musicgen_medium,
        chameleon_34b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_runnable(arch: str, shape: str) -> bool:
    """long_500k needs a sub-quadratic decode path (DESIGN.md §7)."""
    if shape == "long_500k":
        return ARCHS[arch].subquadratic
    return True


def all_cells(include_skipped: bool = False):
    for arch in ARCHS:
        for shape in SHAPES:
            if include_skipped or cell_is_runnable(arch, shape):
                yield arch, shape


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    updates = dict(
        num_layers=2,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        rope_theta=10_000.0,
        model_axis=1,  # no mesh padding in single-device smoke tests
    )
    if cfg.num_heads:
        updates.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
                       head_dim=16)
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16,
        )
        updates.update(num_heads=4, num_kv_heads=4, head_dim=16)
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(
            d_state=16, head_dim=16, expand=2, conv_width=4, chunk=32
        )
    if cfg.moe is not None:
        updates["moe"] = MoEConfig(
            num_experts=4, top_k=min(cfg.moe.top_k, 2),
            num_shared=cfg.moe.num_shared and 1,
        )
    if cfg.global_attn_layers:
        updates["global_attn_layers"] = (0,)
        updates["sliding_window"] = 16
    return dataclasses.replace(cfg, **updates)
