"""Device selection shared by the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU on
their own: a caller that wants the plain PyTorch path asks for
``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is not available,
    so a missing card is reported instead of silently served on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev
