"""Edge-MoE in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``repro`` (JAX/Pallas), package by package under the same
layout.  It imports ``torch`` and numpy only — nothing of JAX or of
``repro``.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, where every kernel module runs its plain
PyTorch version.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine without
    one — an entry point never falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
