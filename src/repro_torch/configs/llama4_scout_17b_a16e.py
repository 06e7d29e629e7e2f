"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.  Image tokens come
pre-embedded via the vision stub (early fusion).
"""

from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    moe=MoEConfig(num_experts=16, top_k=1, num_shared=1),
    rope_theta=500_000.0,
    frontend="vision_stub",
)
