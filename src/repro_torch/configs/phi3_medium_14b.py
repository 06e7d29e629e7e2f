"""phi3-medium-14b — dense, RoPE SwiGLU GQA [arXiv:2404.14219]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
    rope_theta=10_000.0,
)
