"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560, d_ff=0 (no MLP), vocab=50280, ssm_state=128, headdim 64
=> 80 SSM heads.  Sub-quadratic: runs the long_500k decode cell.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    mixer="ssm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    subquadratic=True,
)
