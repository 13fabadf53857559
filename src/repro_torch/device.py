"""Device selection: ``cuda`` unless the caller asks for the CPU.

There is no quiet fallback: asking for (or defaulting to) ``cuda`` on a
machine without a card raises. Resolving a CUDA device also pins fp32
matmuls and convolutions to full fp32 (no TF32), so every fp32 number the
port computes on the card is an fp32 number.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; returns a ``torch.device``. Raises
    ``RuntimeError`` when a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or --device cpu) "
                "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
