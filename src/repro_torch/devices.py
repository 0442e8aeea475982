"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: the default
is ``"cuda"``, and asking for a card that is not there raises instead of
quietly running on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path on the host")
    return dev
