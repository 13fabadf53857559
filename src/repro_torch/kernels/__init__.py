"""The port's hand-written CUDA kernels, one package each, with their
plain versions and launch wrappers (built by ``_build``; B3's, B6's and
B7's launches are PyTorch operators, ``_ops``, which a fake-tensor trace
can see)."""
from __future__ import annotations

import torch


def refuse_grad(name: str, entry: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and one of ``tensors``
    requires a gradient: a ctypes launch returns an output with no
    ``grad_fn``, so autograd would stop there without a word. ``entry``
    is the differentiable function to call instead. Checked before the
    device, so the refusal shows on the CPU too."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its output would cut the autograd "
            f"graph; call {entry} for a differentiable result, or run under "
            "torch.no_grad()")
