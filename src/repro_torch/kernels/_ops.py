"""The launches a traced step can reach, as PyTorch operators.

B3, B6, B7 and B7's backward are reached through ctypes launches, which
read their tensors' ``data_ptr()``: a tensor without storage
(``FakeTensorMode``'s, the dry run's) cannot pass through one. So each of those launches is an
operator of the ``repro_torch`` namespace (``torch.ops.repro_torch.<name>``),
defined here with ``torch.library``, with

  * one kernel, for the ``CUDA`` dispatch key: the launch wrapper's ctypes
    call, unchanged, so a real CUDA tensor always launches the kernel and
    gets the same bits as before;
  * a fake (``register_fake``), which gives the outputs' shapes and dtypes
    from the inputs' and touches no data. It runs only under
    ``FakeTensorMode``; no other tensor has a kernel (the dispatcher
    refuses a CPU or meta tensor), so it is never a fallback;
  * a FLOP formula (``torch.utils.flop_counter.register_flop_formula``),
    which ``FlopCounterMode`` adds up;
  * an HBM byte count, the bytes the kernel must move (each input read
    once, each output written once), in :data:`HBM_BYTES`, which the dry
    run's traffic counter (``utils/memtrack.TrafficCounter``) reads.

The launch wrappers keep their checks and their refusal of an input that
requires a gradient, and call the operator. B1, B2, B4 and B5 keep their
plain Python bindings: no dry run reaches them, and the serving dispatch
that runs them is host-bound.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")

# {operator name: fn(*the operator's arguments) -> bytes}
HBM_BYTES: dict[str, Callable[..., int]] = {}


def define(name: str, schema: str, launch: Callable, fake: Callable,
           flops: Callable, hbm_bytes: Callable):
    """Define ``repro_torch::<name><schema>`` with ``launch`` as its CUDA
    kernel, ``fake`` as its fake, ``flops`` as its FLOP formula (called
    with the tensors' shapes, the other arguments as they are and
    ``out_shape=``) and ``hbm_bytes`` (called with the arguments) as its
    byte count. Returns the operator (its default overload)."""
    LIB.define(name + schema)
    LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    op = getattr(torch.ops.repro_torch, name)
    register_flop_formula(op)(flops)
    HBM_BYTES[name] = hbm_bytes
    return op.default


def nbytes(*tensors) -> int:
    """The bytes of ``tensors``' elements (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
