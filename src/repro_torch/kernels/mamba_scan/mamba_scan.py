"""Launch wrappers of the Mamba1 selective scan kernel (CUDA, B7).

The kernel lives in ``csrc/mamba_scan.cu`` (see its header for the
design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/mamba_scan/mamba_scan.py``. It has two modes, two entry
points here:

* :func:`mamba1_scan` keeps the reference's contract: dt (B, S, di) fp32
  after softplus, x (B, S, di), B_in and C_in (B, S, N), A (di, N), D
  (di,), h0 (B, di, N) or None (zeros) -> y (B, S, di) and hT (B, di,
  N), both fp32.
* :func:`mamba1_scan_gated` fuses the model's composition around the
  scan: dt_raw (the dt_proj output, before its bias), dt_bias (di,),
  A_log (di, N) and z (B, S, di) -> y = silu(z) * the scan of
  softplus(dt_raw + dt_bias) with A = -exp(A_log), in x's dtype, and hT
  fp32.

Each wrapper checks its tensors, allocates y and hT with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its
key of :data:`LAUNCHES`. Neither has a backward, so each refuses an
input that requires a gradient under grad mode
(``ops.gated_selective_scan`` is the differentiable entry of the gated
mode, ``ops.plain_scan`` the contract's). x, B_in and C_in are float32 or bfloat16; every
(B, S, .) operand is read through its batch and position strides as long
as its last dim is unit-stride, so a bf16 activation, the column slices
of one (B, S, R + 2N) projection and the z half of the in_proj output go
as they lie. Any di works (the kernel masks the ragged block). CUDA
tensors only; ``ops.plain_scan`` and ``ops.plain_gated_scan`` serve CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, refuse_grad

# launches of each wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"mamba1_scan": 0, "mamba1_scan_gated": 0}

_SOURCE = "mamba_scan"
STATE_SIZES = (4, 8, 16, 32)  # the kernel's instantiations
GROUPS = (1, 2, 4)  # threads per (batch row, channel), at most N
# threads a grid should have per SM before a channel is split over more
# lanes: on an H100, B * di = 32,768 runs fastest at G = 1 and 8,192 at
# G = 4 over 4,096 steps and more, and a short scan (a decode step), whose
# per-step work is not hidden behind a long sequence, at twice the threads
# (B * di = 32,768 at G = 2); chip_smoke.py phase 20 times every G
_THREADS_PER_SM = 192
_SHORT_SCAN = 64  # steps
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba1_scan_forward.argtypes = ([ptr] * 9 + [i32] * 5 + [i64] * 8
                                        + [i32, ptr])
    lib.mamba1_scan_forward.restype = i32
    lib.mamba1_scan_gated_forward.argtypes = ([ptr] * 11 + [i32] * 5
                                              + [i64] * 10 + [i32, ptr])
    lib.mamba1_scan_gated_forward.restype = i32
    lib.mamba1_scan_error_string.argtypes = [i32]
    lib.mamba1_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def threads_per_channel(rows: int, steps: int, sms: int, N: int) -> int:
    """G, the threads that share one (batch row, channel) of ``rows`` =
    B * di over ``steps`` steps: the smallest of :data:`GROUPS` that gives
    the grid ``_THREADS_PER_SM`` threads on each of ``sms`` SMs (twice
    that below ``_SHORT_SCAN`` steps), else the largest up to N. Fewer
    lanes per channel issue fewer instructions per state (the per-step
    work is not repeated), more lanes fill the card."""
    target = sms * _THREADS_PER_SM * (2 if steps < _SHORT_SCAN else 1)
    groups = [g for g in GROUPS if g <= N]
    for g in groups:
        if rows * g >= target:
            return g
    return groups[-1]


def check_inputs(name: str, dt, x, B_in, C_in, A, D, h0=None) -> None:
    """The rules the contract-mode kernel and its plain version share.
    Raises ``ValueError``."""
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"{name}: dt and x must be one (B, S, di) shape, "
                         f"got {tuple(dt.shape)}/{tuple(x.shape)}")
    _check_bc_state(name, x, B_in, C_in, h0)
    di, N = x.shape[2], B_in.shape[2]
    if A.shape != (di, N) or D.shape != (di,):
        raise ValueError(f"{name}: A must be (di, N) = {(di, N)} and D "
                         f"(di,), got {tuple(A.shape)}/{tuple(D.shape)}")
    if x.dtype not in _DTYPES or B_in.dtype not in _DTYPES \
            or C_in.dtype != B_in.dtype:
        raise ValueError(f"{name}: x must be float32 or bfloat16, and B_in "
                         f"and C_in one of them, got {x.dtype}/"
                         f"{B_in.dtype}/{C_in.dtype}")
    _check_f32(name, "dt, A, D and h0", [dt, A, D, h0])


def check_gated_inputs(name: str, dt_raw, dt_bias, x, B_in, C_in, A_log, D,
                       z, h0=None) -> None:
    """The rules the gated kernel and its plain version share. Raises
    ``ValueError``."""
    if x.ndim != 3 or dt_raw.shape != x.shape or z.shape != x.shape:
        raise ValueError(f"{name}: dt_raw, x and z must be one (B, S, di) "
                         f"shape, got {tuple(dt_raw.shape)}/"
                         f"{tuple(x.shape)}/{tuple(z.shape)}")
    _check_bc_state(name, x, B_in, C_in, h0)
    di, N = x.shape[2], B_in.shape[2]
    if A_log.shape != (di, N) or D.shape != (di,) \
            or dt_bias.shape != (di,):
        raise ValueError(f"{name}: A_log must be (di, N) = {(di, N)}, D and "
                         f"dt_bias (di,), got {tuple(A_log.shape)}/"
                         f"{tuple(D.shape)}/{tuple(dt_bias.shape)}")
    acts = [dt_raw, x, z, B_in, C_in]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in acts):
        raise ValueError(f"{name}: dt_raw, x, z, B_in and C_in must share "
                         "one dtype, float32 or bfloat16, got "
                         f"{[str(t.dtype) for t in acts]}")
    _check_f32(name, "dt_bias, A_log, D and h0", [dt_bias, A_log, D, h0])


def _check_bc_state(name, x, B_in, C_in, h0) -> None:
    Bb, S, di = x.shape
    if B_in.ndim != 3 or B_in.shape[:2] != (Bb, S) \
            or C_in.shape != B_in.shape:
        raise ValueError(f"{name}: B_in and C_in must be (B, S, N) with "
                         f"(B, S) = {(Bb, S)}, got {tuple(B_in.shape)}/"
                         f"{tuple(C_in.shape)}")
    N = B_in.shape[2]
    if h0 is not None and h0.shape != (Bb, di, N):
        raise ValueError(f"{name}: h0 must be (B, di, N) = {(Bb, di, N)}, "
                         f"got {tuple(h0.shape)}")


def _check_f32(name, what, tensors) -> None:
    tensors = [t for t in tensors if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: {what} must be float32, got "
                         f"{[str(t.dtype) for t in tensors]}")


def _on_card(name, x, tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device} "
                         "(ops' plain versions serve CPU tensors)")
    if any(t is not None and t.device != x.device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on {x.device}")


def _group(name, x, N, group) -> int:
    """G for a launch of checked inputs (``group`` if given)."""
    if N not in STATE_SIZES:
        raise ValueError(f"{name}: state size N = {N} not in {STATE_SIZES} "
                         "(the kernel's instantiations)")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: B must be <= 65535")
    if group is None:
        return threads_per_channel(x.shape[0] * x.shape[2], x.shape[1],
                                   _sm_count(x.device), N)
    if group not in GROUPS or group > N:
        raise ValueError(f"{name}: group = {group} not in {GROUPS} or "
                         f"above N = {N}")
    return group


def _rows(*tensors):
    """Each (B, S, .) operand as the kernel reads it (unit-stride last
    dim) with its batch and position strides."""
    out, strides = [], []
    for t in tensors:
        t = t if t.stride(2) == 1 else t.contiguous()
        out.append(t)
        strides += t.stride()[:2]
    return out, strides


def _finish(name, rc):
    if rc != 0:
        msg = _lib().mamba1_scan_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def mamba1_scan(dt: torch.Tensor, x: torch.Tensor, B_in: torch.Tensor,
                C_in: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                h0: torch.Tensor | None = None, *, group: int | None = None):
    """The selective scan on the card, in the reference's contract: (y
    (B, S, di) fp32, hT (B, di, N) fp32), from h0 (zeros when None).
    ``group`` forces G (threads per channel; default: from B * di)."""
    name = "mamba1_scan"
    refuse_grad(name, "ops.plain_scan", dt, x, B_in, C_in, A, D, h0)
    _on_card(name, x, [dt, B_in, C_in, A, D, h0])
    check_inputs(name, dt, x, B_in, C_in, A, D, h0)
    N = B_in.shape[2]
    G = _group(name, x, N, group)
    if B_in.dtype != x.dtype:  # one type for all three: widen (exact)
        x, B_in, C_in = (t.float() for t in (x, B_in, C_in))
    Bb, S, di = x.shape
    (dt, x, B_in, C_in), strides = _rows(dt, x, B_in, C_in)
    A, D = A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=x.device)
    hT = torch.empty((Bb, di, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _finish(name, _lib().mamba1_scan_forward(
        dt.data_ptr(), x.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), hT.data_ptr(), Bb, S, di, N, G, *strides,
        _DTYPES[x.dtype], stream))
    return y, hT


def mamba1_scan_gated(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                      x: torch.Tensor, B_in: torch.Tensor,
                      C_in: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, z: torch.Tensor,
                      h0: torch.Tensor | None = None, *,
                      group: int | None = None):
    """The gated scan on the card: (y (B, S, di) in x's dtype = silu(z) *
    the scan of softplus(dt_raw + dt_bias) with A = -exp(A_log), hT (B,
    di, N) fp32), from h0 (zeros when None). ``group`` as for
    :func:`mamba1_scan`."""
    name = "mamba1_scan_gated"
    refuse_grad(name, "ops.gated_selective_scan", dt_raw, dt_bias, x, B_in,
                C_in, A_log, D, z, h0)
    _on_card(name, x, [dt_raw, dt_bias, B_in, C_in, A_log, D, z, h0])
    check_gated_inputs(name, dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    N = B_in.shape[2]
    G = _group(name, x, N, group)
    Bb, S, di = x.shape
    (dt_raw, x, z, B_in, C_in), strides = _rows(dt_raw, x, z, B_in, C_in)
    dt_bias, A_log, D = (t.contiguous() for t in (dt_bias, A_log, D))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=x.dtype, device=x.device)
    hT = torch.empty((Bb, di, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _finish(name, _lib().mamba1_scan_gated_forward(
        dt_raw.data_ptr(), dt_bias.data_ptr(), x.data_ptr(),
        B_in.data_ptr(), C_in.data_ptr(), A_log.data_ptr(), D.data_ptr(),
        z.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), Bb, S, di, N, G, *strides, _DTYPES[x.dtype], stream))
    return y, hT
