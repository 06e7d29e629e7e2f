"""hymba-1.5b — hybrid: parallel attention + mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba details kept: sliding-window attention everywhere except 3 global
layers (first/middle/last).  Meta tokens are omitted (DESIGN.md §7).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    mixer="hybrid",
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=256),
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    rope_theta=10_000.0,
    subquadratic=True,  # SWA + 3 global layers: long_500k decode is feasible
)
