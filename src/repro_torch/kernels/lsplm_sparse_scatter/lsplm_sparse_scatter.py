"""Launch wrapper of the run-length dTheta scatter kernel (CUDA, B2).

The kernel lives in ``csrc/lsplm_sparse_scatter.cu`` (see its header for
the design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/lsplm_sparse_scatter/lsplm_sparse_scatter.py``. The
wrapper checks its tensors, allocates the output and the partial-sum
scratch with ``torch.empty``, launches on PyTorch's current stream
without synchronising, raises if a launch was refused, and adds one to
:data:`LAUNCHES`. It takes CUDA tensors only: the plain versions in
``ops.py`` serve CPU tensors.

Unlike the TPU kernel, the sorted entries need no sentinel padding: the
plan's piece table (``plan.run_pieces``) says where each run starts and
ends.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches of the wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"lsplm_sparse_scatter_compact": 0}

_SOURCE = "lsplm_sparse_scatter"
_MAX_COLUMNS = 128  # the kernel keeps at most 4 x 32 columns per lane


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lsplm_sparse_scatter_compact.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.lsplm_sparse_scatter_compact.restype = i32
    lib.lsplm_scatter_error_string.argtypes = [i32]
    lib.lsplm_scatter_error_string.restype = ctypes.c_char_p
    return lib


def _check(piece_start, piece_run, run_piece_start, sample_sorted,
           vals_sorted, dz) -> None:
    name = "lsplm_sparse_scatter_compact"
    if dz.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dz.device} "
                         "(the plain versions in ops.py serve CPU tensors)")
    ints = (piece_start, piece_run, run_piece_start, sample_sorted)
    if any(t.device != dz.device for t in (*ints, vals_sorted)):
        raise ValueError(f"{name}: every tensor must lie on {dz.device}")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: the piece tables and sample_sorted must "
                         "be int32")
    if vals_sorted.dtype != torch.float32 or dz.dtype != torch.float32:
        raise ValueError(f"{name}: vals_sorted and dz must be float32, got "
                         f"{vals_sorted.dtype}/{dz.dtype}")
    if any(t.ndim != 1 for t in (*ints, vals_sorted)):
        raise ValueError(f"{name}: the piece tables and sorted entries must "
                         "be 1-D")
    if (piece_start.numel() != piece_run.numel() + 1
            or run_piece_start.numel() < 1
            or sample_sorted.numel() != vals_sorted.numel()):
        raise ValueError(
            f"{name}: inconsistent sizes: piece_start {piece_start.numel()}, "
            f"piece_run {piece_run.numel()}, run_piece_start "
            f"{run_piece_start.numel()}, entries {sample_sorted.numel()}/"
            f"{vals_sorted.numel()}")
    if dz.ndim != 2 or not 1 <= dz.shape[1] <= _MAX_COLUMNS:
        raise ValueError(f"{name}: dz must be (N, 2m) with 2m <= "
                         f"{_MAX_COLUMNS}, got {tuple(dz.shape)}")
    if not all(t.is_contiguous() for t in (*ints, vals_sorted, dz)):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if max(sample_sorted.numel(), dz.numel(), piece_run.numel()) >= 2**31:
        raise ValueError(f"{name}: sizes must fit in int32")


def lsplm_sparse_scatter_compact(piece_start: torch.Tensor,
                                 piece_run: torch.Tensor,
                                 run_piece_start: torch.Tensor,
                                 sample_sorted: torch.Tensor,
                                 vals_sorted: torch.Tensor,
                                 dz: torch.Tensor) -> torch.Tensor:
    """Segment-sum the id-sorted entries into the compact (U+1, 2m) fp32
    result on the card: row u is the sum of ``vals_sorted[e] *
    dz[sample_sorted[e]]`` over run u, row U is exactly zero. The piece
    tables come from ``plan.run_pieces``; U = ``run_piece_start.numel() -
    1``."""
    _check(piece_start, piece_run, run_piece_start, sample_sorted,
           vals_sorted, dz)
    num_unique = run_piece_start.numel() - 1
    num_pieces = piece_run.numel()
    m2 = dz.shape[1]
    compact = torch.empty((num_unique + 1, m2), dtype=torch.float32,
                          device=dz.device)
    partial = torch.empty((max(num_pieces, 1), m2), dtype=torch.float32,
                          device=dz.device)
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    rc = _lib().lsplm_sparse_scatter_compact(
        piece_start.data_ptr(), piece_run.data_ptr(),
        run_piece_start.data_ptr(), sample_sorted.data_ptr(),
        vals_sorted.data_ptr(), dz.data_ptr(), partial.data_ptr(),
        compact.data_ptr(), num_pieces, num_unique, m2, stream)
    if rc != 0:
        msg = _lib().lsplm_scatter_error_string(rc).decode()
        raise RuntimeError(f"lsplm_sparse_scatter_compact: kernel launch "
                           f"failed: {msg} ({rc})")
    LAUNCHES["lsplm_sparse_scatter_compact"] += 1
    return compact
