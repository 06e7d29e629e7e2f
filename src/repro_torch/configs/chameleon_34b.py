"""chameleon-34b — early-fusion VLM over VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8 per assignment spec) d_ff=22016 vocab=65536.
QK-norm kept (chameleon's divergence fix).  The VQ-VAE image tokenizer is a
stub: input_specs() provides pre-tokenized patch embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65_536,
    qk_norm=True,
    rope_theta=10_000.0,
    frontend="vision_stub",
)
