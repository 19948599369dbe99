"""Device choice for the port's entry points: the card unless asked."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if that is CUDA and there is none.

    The entry points default to ``"cuda"`` and never carry on silently
    on the CPU: the caller asks for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu on "
            "the command line) to run on the CPU")
    return dev
