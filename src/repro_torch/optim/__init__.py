from repro_torch.optim.adamw import (
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim.grad_compress import (
    GRAD_LZ,
    compress_leaf,
    decompress_leaf,
    dequantize_u16,
    lossy_grad_config,
    pod_exchange_compressed,
    quantize_u16,
)

__all__ = [
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "lr_schedule",
    "GRAD_LZ",
    "compress_leaf",
    "decompress_leaf",
    "dequantize_u16",
    "lossy_grad_config",
    "pod_exchange_compressed",
    "quantize_u16",
]
