"""Launch wrappers of the fused sparse LS-PLM forward kernels (CUDA).

The kernels live in ``csrc/lsplm_sparse_fused.cu`` (see its header for
the design and what bounds it) and replace the two Pallas kernels of
``repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py``. Each wrapper
checks its tensors (CUDA, dtypes, contiguity, shapes), allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its
entry in :data:`LAUNCHES`.

Unlike the TPU kernels, ragged N and K need no padding: each warp owns one
row and reads exactly its K slots. Theta (or the int8 codes) must carry
the reserved zero pad row at id D-1 (``ops.pad_theta``); pad slots load
nothing. These wrappers take CUDA tensors only -- the plain versions in
``ops.py`` serve CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per wrapper, for runs that must show they went through the
# kernels (reset by the caller, read after the run)
LAUNCHES = {"lsplm_sparse_fused_forward": 0,
            "lsplm_sparse_fused_int8_forward": 0}

_SOURCE = "lsplm_sparse_fused"
_MAX_COLUMNS = 128  # the kernel keeps at most 4 x 32 columns per lane


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call
    builds the source if needed)."""
    lib = _build.load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lsplm_sparse_fused_forward.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.lsplm_sparse_fused_forward.restype = i32
    lib.lsplm_sparse_fused_int8_forward.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.lsplm_sparse_fused_int8_forward.restype = i32
    lib.lsplm_cuda_error_string.argtypes = [i32]
    lib.lsplm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, ids: torch.Tensor, vals: torch.Tensor,
           rows: torch.Tensor, rows_dtype: torch.dtype) -> None:
    if ids.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {ids.device} "
                         "(the plain version in ops.py serves CPU tensors)")
    if vals.device != ids.device or rows.device != ids.device:
        raise ValueError(f"{name}: ids, vals and rows must share one device, "
                         f"got {ids.device}/{vals.device}/{rows.device}")
    if ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise ValueError(f"{name}: ids must be int32 and vals float32, got "
                         f"{ids.dtype}/{vals.dtype}")
    if rows.dtype != rows_dtype:
        raise ValueError(f"{name}: rows must be {rows_dtype}, got {rows.dtype}")
    if ids.ndim != 2 or ids.shape != vals.shape:
        raise ValueError(f"{name}: ids/vals must be (N, K), got "
                         f"{tuple(ids.shape)}/{tuple(vals.shape)}")
    if (rows.ndim != 2 or rows.shape[1] % 2 or rows.shape[0] < 1
            or not 2 <= rows.shape[1] <= _MAX_COLUMNS):
        raise ValueError(f"{name}: rows must be (D, 2m) with D >= 1 and "
                         f"2 <= 2m <= {_MAX_COLUMNS}, got {tuple(rows.shape)}")
    if not (ids.is_contiguous() and vals.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError(f"{name}: ids, vals and rows must be contiguous")
    if ids.numel() >= 2**31 or rows.shape[0] >= 2**31:
        raise ValueError(f"{name}: sizes must fit in int32")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().lsplm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")


def lsplm_sparse_fused_forward(ids: torch.Tensor, vals: torch.Tensor,
                               theta: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused fp32 forward on the card. ids (N, K) int32 with pad id
    D-1, vals (N, K) float32, theta (D, 2m) float32 with its zero pad
    row. Returns (p (N,), z (N, 2m)) float32."""
    name = "lsplm_sparse_fused_forward"
    _check(name, ids, vals, theta, torch.float32)
    n, k = ids.shape
    d, m2 = theta.shape
    p = torch.empty((n,), dtype=torch.float32, device=ids.device)
    z = torch.empty((n, m2), dtype=torch.float32, device=ids.device)
    if n == 0:
        return p, z
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    rc = _lib().lsplm_sparse_fused_forward(
        ids.data_ptr(), vals.data_ptr(), theta.data_ptr(), p.data_ptr(),
        z.data_ptr(), n, k, d, m2 // 2, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return p, z


def lsplm_sparse_fused_int8_forward(ids: torch.Tensor, vals: torch.Tensor,
                                    codes: torch.Tensor, scales: torch.Tensor
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8-native forward on the card: rows are ``codes[i] *
    scales[i]`` formed in registers (fp32 rows never exist). codes (D, 2m)
    int8 with its zero pad row, scales (D,) float32 (pad scale 0).
    Returns (p (N,), z (N, 2m)) float32."""
    name = "lsplm_sparse_fused_int8_forward"
    _check(name, ids, vals, codes, torch.int8)
    if (scales.dtype != torch.float32 or scales.device != ids.device
            or tuple(scales.shape) != (codes.shape[0],)
            or not scales.is_contiguous()):
        raise ValueError(f"{name}: scales must be a contiguous float32 "
                         f"({codes.shape[0]},) tensor on {ids.device}, got "
                         f"{scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    n, k = ids.shape
    d, m2 = codes.shape
    p = torch.empty((n,), dtype=torch.float32, device=ids.device)
    z = torch.empty((n, m2), dtype=torch.float32, device=ids.device)
    if n == 0:
        return p, z
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    rc = _lib().lsplm_sparse_fused_int8_forward(
        ids.data_ptr(), vals.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        p.data_ptr(), z.data_ptr(), n, k, d, m2 // 2, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return p, z
