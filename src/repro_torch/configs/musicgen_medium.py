"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.  The EnCodec frontend is a
stub: input_specs() provides precomputed frame embeddings; the 4-codebook
delay pattern is collapsed to a single stream (DESIGN.md §7).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10_000.0,
    frontend="audio_stub",
)
