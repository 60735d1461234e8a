"""Device selection shared by the port's entry points.

The port runs on the CUDA card. An entry point given no ``device`` takes
``cuda`` and raises when no card is present: the port never falls back to
the CPU on its own. Callers that want the CPU (the tests) ask for it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU),
    so that a host clock read after it times the work and not its
    enqueueing."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
