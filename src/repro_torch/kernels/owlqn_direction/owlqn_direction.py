"""Launch wrapper of the Eq. 9 direction kernel (CUDA, B3).

The kernel lives in ``csrc/owlqn_direction.cu`` (see its header for the
design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/owlqn_direction/owlqn_direction.py``. The wrapper checks
its tensors and calls the operator ``torch.ops.repro_torch.owlqn_direction``
(``kernels/_ops.py``), whose CUDA kernel allocates d with ``torch.empty``,
launches on PyTorch's current stream without synchronising, raises if the
launch was refused, and adds one to :data:`LAUNCHES`; under
``FakeTensorMode`` its fake gives d's shape instead (the dry run). Unlike
the TPU kernel it needs no row
count divisible by a block: the kernel masks the last tile. The kernel
picks its design from 2m and the tensors' alignment (64-row tiles, four
threads a row, for 2m = 4, 8, ..., 32 on 16-byte aligned tensors, else
a warp per row); both give the same bits. CUDA tensors only; ``ref.py``
serves CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _ops

# launches of the wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"owlqn_direction": 0}

_SOURCE = "owlqn_direction"
_MAX_COLUMNS = 128  # the kernel keeps at most 4 x 32 columns per lane


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.owlqn_direction.argtypes = [ptr] * 3 + [i32] * 2 + [f32] * 2 + [ptr]
    lib.owlqn_direction.restype = i32
    lib.owlqn_direction_error_string.argtypes = [i32]
    lib.owlqn_direction_error_string.restype = ctypes.c_char_p
    return lib


def owlqn_direction(theta: torch.Tensor, grad: torch.Tensor, lam: float,
                    beta: float) -> torch.Tensor:
    """The Eq. 9 direction d (D, 2m) float32 on the card from Theta and
    the smooth gradient, both contiguous (D, 2m) float32 CUDA tensors.
    ``lam`` and ``beta`` are taken as float32, as the plain version's
    scalar arithmetic on float32 tensors does."""
    name = "owlqn_direction"
    if theta.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {theta.device} "
                         "(ref.owlqn_direction_ref serves CPU tensors)")
    if grad.device != theta.device:
        raise ValueError(f"{name}: theta and grad must share one device, "
                         f"got {theta.device}/{grad.device}")
    if theta.dtype != torch.float32 or grad.dtype != torch.float32:
        raise ValueError(f"{name}: theta and grad must be float32, got "
                         f"{theta.dtype}/{grad.dtype}")
    if (theta.ndim != 2 or grad.shape != theta.shape
            or not 1 <= theta.shape[1] <= _MAX_COLUMNS):
        raise ValueError(f"{name}: theta and grad must be one (D, 2m) shape "
                         f"with 2m <= {_MAX_COLUMNS}, got "
                         f"{tuple(theta.shape)}/{tuple(grad.shape)}")
    if not (theta.is_contiguous() and grad.is_contiguous()):
        raise ValueError(f"{name}: theta and grad must be contiguous")
    if theta.numel() >= 2**31:
        raise ValueError(f"{name}: sizes must fit in int32")
    return _OP(theta, grad, float(lam), float(beta))


def _launch(theta, grad, lam, beta):
    """The operator's CUDA kernel: the launch, on checked tensors."""
    name = "owlqn_direction"
    d_rows, m2 = theta.shape
    out = torch.empty_like(theta)
    if d_rows == 0:
        return out
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = _lib().owlqn_direction(theta.data_ptr(), grad.data_ptr(),
                                out.data_ptr(), d_rows, m2, lam, beta,
                                stream)
    if rc != 0:
        msg = _lib().owlqn_direction_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return out


def _flops(theta, grad, lam, beta, out_shape=None) -> int:
    """~16 operations an element: the row's sum of squares and its
    square root, the three cases' products, clamps and signs, the
    select."""
    return 16 * theta[0] * theta[1]


def _fake(theta, grad, lam, beta):
    return torch.empty_like(theta)


def _hbm_bytes(theta, grad, lam, beta) -> int:
    """Theta and the gradient read once, d written once."""
    return _ops.nbytes(theta, grad, theta)


_OP = _ops.define("owlqn_direction", "(Tensor theta, Tensor grad, float lam, "
                  "float beta) -> Tensor", _launch, _fake, _flops, _hbm_bytes)
