"""Where the port's entry points put their tensors.

Every entry point that builds tensors (scenes, cameras, training state,
targets) builds them on the CUDA card unless the caller asks for the CPU.
There is no silent fallback: without a card, asking for "cuda" raises.  On
CPU tensors every kernel wrapper runs its plain PyTorch version, which is how
the tests run the port.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; raises for CUDA when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
