"""Config dataclasses for the model zoo, training, serving and compression.

A field-for-field copy of the reference's ``configs/base.py``, so that both
packages build the same shapes from the same config.

Mesh-divisibility padding: the reference's production mesh fixes the model
axis at 16, so head/vocab counts that do not divide 16 are padded up (extra
heads / rows, the MaxText convention).  The port computes what the reference
computes and keeps the padding, though it has no model-parallel mesh; the
unpadded counts stay in the plain fields and ``param_count(padded=False)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MODEL_AXIS = 16  # model-parallel degree of the production mesh


def pad_to(n: int, m: int = MODEL_AXIS) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | moe | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    mixer: str = "attention"         # attention | mla | ssm | hybrid
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    qk_norm: bool = False
    sliding_window: int = 0          # 0 => full attention everywhere
    global_attn_layers: Tuple[int, ...] = ()
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    frontend: str = "text"           # text | audio_stub | vision_stub
    subquadratic: bool = False       # can run long_500k decode
    model_axis: int = MODEL_AXIS     # padding granularity (1 = no padding)
    kv_quant: bool = False           # int8 KV cache (decode memory lever)

    # ----- derived (padded for the model axis) -----
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_heads(self) -> int:
        return pad_to(self.num_heads, self.model_axis)

    @property
    def padded_kv_heads(self) -> int:
        return pad_to(self.num_kv_heads, self.model_axis) if self.num_kv_heads else 0

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.model_axis)

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return (self.d_model * self.ssm.expand) // self.ssm.head_dim

    @property
    def padded_ssm_heads(self) -> int:
        return pad_to(self.ssm_heads, self.model_axis)

    def param_count(self, padded: bool = False) -> int:
        """Analytic parameter count (true or padded)."""
        h = self.padded_heads if padded else self.num_heads
        kv = self.padded_kv_heads if padded else self.num_kv_heads
        v = self.padded_vocab if padded else self.vocab_size
        d, dh, L = self.d_model, self.hd, self.num_layers
        per_layer = 0
        if self.mixer in ("attention", "hybrid"):
            per_layer += d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.mixer == "mla":
            m = self.mla
            per_layer += (
                d * m.q_lora_rank
                + m.q_lora_rank * h * (m.qk_nope_dim + m.qk_rope_dim)
                + d * m.kv_lora_rank
                + d * m.qk_rope_dim
                + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                + h * m.v_head_dim * d
            )
        if self.mixer in ("ssm", "hybrid"):
            s = self.ssm
            heads = (
                self.padded_ssm_heads if padded else self.ssm_heads
            )
            di = heads * s.head_dim
            per_layer += (
                d * (2 * di + 2 * s.d_state)  # in_proj: x, z, B, C
                + d * heads                    # dt proj
                + s.conv_width * (di + 2 * s.d_state)
                + 2 * heads                    # A_log, D
                + di * d                       # out_proj
            )
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.num_experts  # router
            per_layer += 3 * d * self.d_ff * (e.num_experts + e.num_shared)
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff  # SwiGLU
        per_layer += 2 * d  # norms
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d = self.d_model
        skipped = 3 * d * self.d_ff * (e.num_experts - e.top_k)
        return self.param_count() - self.num_layers * skipped


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Framework-level GPULZ integration knobs."""

    checkpoint: bool = True          # GPULZ on checkpoint shards
    checkpoint_symbol_size: int = 4  # fp32 shards
    grad_cross_pod: bool = False     # quantize+LZSS the pod-axis grad exchange
    grad_ratio_cap: float = 2.0      # fixed buffer = quantized_size / cap
    lossy_eb: Optional[float] = None  # error-bounded lossy GRADIENT exchange
                                     # (optim/grad_compress.py lossy-fz path:
                                     # max |g' - g| <= eb per element when the
                                     # slab fits its wire budget); optimizer
                                     # state and checkpoints stay lossless —
                                     # None = the u16-quantize legacy path
    kv_eviction: bool = False        # compress cold KV blocks on eviction
    lz_backend: str = "auto"         # compressor backend registry key
                                     # (core/pipeline.py); "auto" = the
                                     # one-launch fused-mono compressor on
                                     # cuda, the plain torch path on cpu
    lz_decoder: str = "auto"         # decode registry key; "auto" = the
                                     # one-launch fused-mono decoder on
                                     # cuda, torch-parallel on cpu


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    remat: str = "full"              # full | dots | none
    unroll_layers: bool = False      # python layer loop (the reference's
                                     # dry-run cost mode; kept for parity)
    fsdp: str = "on"                 # on | off | auto (by model size)
    seq_parallel: bool = False       # Megatron SP on the residual stream
    zero_opt_state: bool = True      # shard opt state over data axis too
    seed: int = 0
    compression: CompressionConfig = CompressionConfig()
