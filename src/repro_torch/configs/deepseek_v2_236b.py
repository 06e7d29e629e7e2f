"""deepseek-v2-236b — MoE with multi-head latent attention [arXiv:2405.04434].

60L d_model=5120 128H, MLA kv_lora=512, 2 shared + 160 routed experts top-6,
expert d_ff=1536, vocab=102400.  Per the assignment spec all layers are MoE
(the HF release keeps layer 0 dense — noted deviation, spec-driven).
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: latent cache, kv head count unused in params
    d_ff=1536,
    vocab_size=102_400,
    mixer="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared=2),
    rope_theta=10_000.0,
)
