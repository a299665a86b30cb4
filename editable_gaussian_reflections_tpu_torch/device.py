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


# how many processes share this process's card (parallel/mesh.py spawn sets
# it in each rank): memory budgets take the card over this many
_RANKS_PER_CARD = 1


def share_card(ranks: int) -> None:
    """Declare that `ranks` processes (this one included) share its card."""
    global _RANKS_PER_CARD
    if ranks < 1:
        raise ValueError(f"ranks={ranks}: at least 1 process uses the card")
    _RANKS_PER_CARD = ranks


def ranks_per_card() -> int:
    """How many processes share this process's card (1 unless a spawn of
    parallel/mesh.py placed several ranks on it)."""
    return _RANKS_PER_CARD
