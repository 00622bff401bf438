"""PyTorch/CUDA port of the ``tpuserver`` serving stack, for NVIDIA
Hopper (H100).

The JAX package ``tpuserver`` is the reference; this package imports
nothing of it (nor JAX) and keeps its own copy of what it needs.  Its
attention kernels are hand-written CUDA for ``sm_90a`` under ``csrc/``,
built at first use (``tpuserver_torch.ops._build``).

Every entry point takes ``device=`` and runs on the card unless the
caller asks for the CPU: see :func:`resolve_device`.
"""

import torch


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the card (``cuda``), and raises RuntimeError when no
    CUDA device exists: the port never falls back to the CPU on its own.
    ``"cpu"`` (or any explicit device) is taken as given; an explicit
    CUDA device without a card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpuserver_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev
