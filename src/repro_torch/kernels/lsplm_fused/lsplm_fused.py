"""Launch wrapper of the dense fused LS-PLM forward kernel (CUDA, B5).

The kernel lives in ``csrc/lsplm_fused.cu`` (see its header for the
design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/lsplm_fused/lsplm_fused.py``. The wrapper keeps the
reference's ``(x, u, w)`` signature, checks its tensors, allocates p
with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to
:data:`LAUNCHES`. It has no backward, so it refuses an input that
requires a gradient under grad mode (the NLL's differentiable forward
is ``core.lsplm.predict_logits_stable``).

The kernel reads U and W as one row-major Theta = [U | W] of row stride
ldt = 2m rounded up to 16 bytes. The two halves of the port's own (d, 2m)
Theta -- ``theta[:, :m]`` and ``theta[:, m:]``, with 2m a multiple of 16
bytes, as at m = 12 -- are that already and go as they lie; any other
U, W are packed into one such tensor first. x's rows are read with
16-byte loads when they are 16-byte aligned and d is a multiple of 16
bytes, element by element otherwise. Ragged B and d need no padding.
The kernel splits d into :func:`num_chunks` chunks of :data:`CHUNK`
columns (a count that depends on d alone, so a row's bits do not depend
on its batch) and adds their fp32 partial sums in a second launch; the
wrapper allocates that (chunks, B, 2m) scratch with ``torch.empty``.
CUDA tensors only; ``ref.py`` serves CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, refuse_grad

# launches of the wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"lsplm_fused_forward": 0}

_SOURCE = "lsplm_fused"
MAX_REGIONS = 128  # the reference kernel's stated limit on m
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 2048  # columns of d per chunk (a multiple of 128)
MAX_CHUNKS = 65535  # the grid's second dimension


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lsplm_fused_forward.argtypes = ([ptr] * 4 + [i32] * 3 + [i64]
                                        + [i32] * 4 + [ptr])
    lib.lsplm_fused_forward.restype = i32
    lib.lsplm_fused_error_string.argtypes = [i32]
    lib.lsplm_fused_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(name: str, x: torch.Tensor, u: torch.Tensor,
                 w: torch.Tensor) -> None:
    """The shape, dtype and region-count rules the kernel and its plain
    version share: x (B, d), u and w (d, m) with 1 <= m <= 128, all
    float32 or all bfloat16. Raises ``ValueError``."""
    if x.ndim != 2 or u.ndim != 2 or u.shape != w.shape \
            or u.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x must be (B, d) and u, w (d, m), got "
                         f"{tuple(x.shape)}/{tuple(u.shape)}/"
                         f"{tuple(w.shape)}")
    if not 1 <= u.shape[1] <= MAX_REGIONS:
        raise ValueError(f"{name}: m must be in [1, {MAX_REGIONS}] "
                         f"(the kernel's limit), got {u.shape[1]}")
    if x.dtype not in _DTYPES or u.dtype != x.dtype or w.dtype != x.dtype:
        raise ValueError(f"{name}: x, u and w must all be float32 or all "
                         f"bfloat16, got {x.dtype}/{u.dtype}/{w.dtype}")


def num_chunks(d: int) -> int:
    """How many chunks of :data:`CHUNK` columns the kernel cuts d into
    (at least one): a function of d alone."""
    return max(1, -(-d // CHUNK))


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` when its rows lie apart with unit-stride columns (what the
    kernel reads through a base pointer and a row stride), else a
    contiguous copy."""
    rows, cols = t.shape
    if (t.stride(1) == 1 or cols == 1) and (t.stride(0) >= cols or rows == 1):
        return t
    return t.contiguous()


def _packed_theta(u: torch.Tensor, w: torch.Tensor
                  ) -> tuple[torch.Tensor, int]:
    """(a tensor whose storage starts with the row-major Theta =
    [U | W | zeros] the kernel reads, its row stride ldt): U itself when
    U and W are the two halves of a (d, 2m) row-major tensor with 2m a
    multiple of 16 bytes, else a packed copy with ldt = 2m rounded up to
    16 bytes."""
    d, m = u.shape
    vec = 16 // u.element_size()
    ldt = -(-2 * m // vec) * vec
    halves = (ldt == 2 * m and u.data_ptr() % 16 == 0
              and w.data_ptr() == u.data_ptr() + m * u.element_size()
              and all(t.stride(1) == 1 or m == 1 for t in (u, w))
              and (d == 1 or u.stride(0) == w.stride(0) == ldt))
    if halves:
        return u, ldt
    theta = u.new_zeros((d, ldt))
    theta[:, :m] = u
    theta[:, m:2 * m] = w
    return theta, ldt


def lsplm_fused_forward(x: torch.Tensor, u: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 on the card: x (B, d), u and w (d, m) CUDA
    tensors of one dtype (float32, or bfloat16 with fp32 accumulation).
    Returns p (B,) in x's dtype."""
    name = "lsplm_fused_forward"
    refuse_grad(name, "core.lsplm.predict_logits_stable", x, u, w)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device} "
                         "(ref.lsplm_forward_ref serves CPU tensors)")
    if u.device != x.device or w.device != x.device:
        raise ValueError(f"{name}: x, u and w must share one device, got "
                         f"{x.device}/{u.device}/{w.device}")
    check_inputs(name, x, u, w)
    (b, d), m = x.shape, u.shape[1]
    if b >= 2**31 or num_chunks(d) > MAX_CHUNKS:
        raise ValueError(f"{name}: B must fit in int32 and d in "
                         f"{MAX_CHUNKS} chunks of {CHUNK} columns")
    p = torch.empty((b,), dtype=x.dtype, device=x.device)
    if b == 0:
        return p
    x = _as_rows(x)
    theta, ldt = _packed_theta(u, w)
    ldx = x.stride(0) if b > 1 else d
    vec = 16 // x.element_size()
    vec_x = x.data_ptr() % 16 == 0 and ldx % vec == 0 and d % vec == 0
    scratch = torch.empty((num_chunks(d), b, 2 * m), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().lsplm_fused_forward(
        x.data_ptr(), theta.data_ptr(), p.data_ptr(), scratch.data_ptr(), b,
        d, m, ldx, ldt, CHUNK, int(vec_x), _DTYPES[x.dtype], stream)
    if rc != 0:
        msg = _lib().lsplm_fused_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return p
