"""The port's hand-written CUDA kernels and their plain PyTorch versions."""

from tpuserver_torch.ops.flash import (  # noqa: F401
    decode_attention,
    decode_attention_reference,
    flash_attention,
    flash_attention_reference,
    reset_launch_counts,
)
