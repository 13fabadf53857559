"""Launch wrapper of the Mamba1 selective scan kernel (CUDA, B7).

The kernel lives in ``csrc/mamba_scan.cu`` (see its header for the
design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/mamba_scan/mamba_scan.py``. The wrapper checks its
tensors, allocates y and hT with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises if the launch was refused,
and adds one to :data:`LAUNCHES`.

dt and x are (B, S, di), B_in and C_in (B, S, N), A (di, N), D (di,) and
h0 (B, di, N) or None (zeros). dt, A, D and h0 are float32; x is float32
or bfloat16, and so are B_in and C_in (one type for both). dt, x, B_in
and C_in are read through their batch and position strides as long as
their last dim is unit-stride: a bf16 activation and the column slices
of one (B, S, R + 2N) projection go as they lie. Returns y (B, S, di)
and hT (B, di, N), both float32 whatever x's type (the model gates y in
fp32). Any di works (the kernel masks the ragged block). CUDA tensors
only; ``ops.plain_scan`` serves CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches of the wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"mamba1_scan": 0}

_SOURCE = "mamba_scan"
STATE_SIZES = (4, 8, 16, 32)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba1_scan_forward.argtypes = ([ptr] * 9 + [i32] * 4 + [i64] * 8
                                        + [i32] * 2 + [ptr])
    lib.mamba1_scan_forward.restype = i32
    lib.mamba1_scan_error_string.argtypes = [i32]
    lib.mamba1_scan_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(name: str, dt, x, B_in, C_in, A, D, h0=None) -> None:
    """The rules the kernel and its plain version share. Raises
    ``ValueError``."""
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"{name}: dt and x must be one (B, S, di) shape, "
                         f"got {tuple(dt.shape)}/{tuple(x.shape)}")
    Bb, S, di = x.shape
    if B_in.ndim != 3 or B_in.shape[:2] != (Bb, S) \
            or C_in.shape != B_in.shape:
        raise ValueError(f"{name}: B_in and C_in must be (B, S, N) with "
                         f"(B, S) = {(Bb, S)}, got {tuple(B_in.shape)}/"
                         f"{tuple(C_in.shape)}")
    N = B_in.shape[2]
    if A.shape != (di, N) or D.shape != (di,):
        raise ValueError(f"{name}: A must be (di, N) = {(di, N)} and D "
                         f"(di,), got {tuple(A.shape)}/{tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bb, di, N):
        raise ValueError(f"{name}: h0 must be (B, di, N) = {(Bb, di, N)}, "
                         f"got {tuple(h0.shape)}")
    if x.dtype not in _DTYPES or B_in.dtype not in _DTYPES \
            or C_in.dtype != B_in.dtype:
        raise ValueError(f"{name}: x must be float32 or bfloat16, and B_in "
                         f"and C_in one of them, got {x.dtype}/"
                         f"{B_in.dtype}/{C_in.dtype}")
    rest = [dt, A, D] + ([] if h0 is None else [h0])
    if any(t.dtype != torch.float32 for t in rest):
        raise ValueError(f"{name}: dt, A, D and h0 must be float32, got "
                         f"{[str(t.dtype) for t in rest]}")


def mamba1_scan(dt: torch.Tensor, x: torch.Tensor, B_in: torch.Tensor,
                C_in: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                h0: torch.Tensor | None = None):
    """The selective scan on the card: (y (B, S, di) fp32, hT (B, di, N)
    fp32), from h0 (zeros when None)."""
    name = "mamba1_scan"
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device} "
                         "(ops.plain_scan serves CPU tensors)")
    tensors = [dt, B_in, C_in, A, D] + ([] if h0 is None else [h0])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on {x.device}")
    check_inputs(name, dt, x, B_in, C_in, A, D, h0)
    Bb, S, di = x.shape
    N = B_in.shape[2]
    if N not in STATE_SIZES:
        raise ValueError(f"{name}: state size N = {N} not in {STATE_SIZES} "
                         "(the kernel's instantiations)")
    if Bb > 65535:
        raise ValueError(f"{name}: B must be <= 65535")
    dt, x, B_in, C_in = (t if t.stride(2) == 1 else t.contiguous()
                         for t in (dt, x, B_in, C_in))
    A, D = A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=x.device)
    hT = torch.empty((Bb, di, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().mamba1_scan_forward(
        dt.data_ptr(), x.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), hT.data_ptr(), Bb, S, di, N, *dt.stride()[:2],
        *x.stride()[:2], *B_in.stride()[:2], *C_in.stride()[:2],
        _DTYPES[x.dtype], _DTYPES[B_in.dtype], stream)
    if rc != 0:
        msg = _lib().mamba1_scan_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return y, hT
