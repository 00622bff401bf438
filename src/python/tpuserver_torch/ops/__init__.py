"""The port's hand-written CUDA kernels and their plain PyTorch versions."""

from tpuserver_torch.ops import flash, quant
from tpuserver_torch.ops.flash import (  # noqa: F401
    decode_attention,
    decode_attention_reference,
    flash_attention,
    flash_attention_reference,
)
from tpuserver_torch.ops.quant import (  # noqa: F401
    int8_matmul,
    int8_matmul_reference,
)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    flash.reset_launch_counts()
    quant.reset_launch_counts()
