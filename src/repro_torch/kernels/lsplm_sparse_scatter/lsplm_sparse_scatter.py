"""Launch wrapper of the run-length dTheta scatter kernel (CUDA, B2).

The kernel lives in ``csrc/lsplm_sparse_scatter.cu`` (see its header for
the design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/lsplm_sparse_scatter/lsplm_sparse_scatter.py``. It writes
the whole dense (D, 2m) dTheta: no gather densifies it afterwards, and it
reads ``vals`` through the layout's ``order`` itself. The wrapper checks
its tensors, allocates the output and the partial-sum scratch with
``torch.empty``, launches the kernel on PyTorch's current stream
without synchronising, raises if a launch was refused, and adds one to
:data:`LAUNCHES`. The run tickets live in one int32 buffer per CUDA
stream, zeroed once when it is made or grown: the kernel leaves every
ticket at 0 again. It takes CUDA tensors only: the plain versions in
``ops.py`` and ``ref.py`` serve CPU tensors.

Unlike the TPU kernel, the sorted entries need no sentinel padding: the
plan's piece and task tables (``plan.run_pieces``) say where each run
starts and ends and which warp takes it.

``block_e`` (128, 256 or 512: 4, 8 or 16 task warps a block, 32 sorted
entries a warp) sets the block size; None is the 256 every launch had
before the tune table (``ops._scatter_card`` passes what
``repro_torch.tune`` resolves). It decides which warp takes which task,
never the order of a sum. A ``block_e`` outside the grid, or one whose
row buffers (32 dz rows a warp) exceed a block's shared memory
(:func:`max_block_e`, from the .cu), raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches of the wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"lsplm_sparse_scatter": 0}

_SOURCE = "lsplm_sparse_scatter"
_MAX_COLUMNS = 128  # the kernel keeps at most 4 x 32 columns per lane
BLOCK_E_GRID = (128, 256, 512)  # sorted entries a task block covers
DEFAULT_BLOCK_E = 256  # 8 task warps a block
OVER_BUDGET = -1  # the launch's refusal of a block_e (kOverBudget)
# the run tickets of each (device, stream): all 0 between calls
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
# the layout's int32 tables, in the C function's argument order
_TABLES = ("task_piece_start", "piece_start", "piece_run", "run_piece_start",
           "row_ids", "order", "sample_sorted", "inv_sorted")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lsplm_sparse_scatter.argtypes = [ptr] * 13 + [i32] * 5 + [ptr]
    lib.lsplm_sparse_scatter.restype = i32
    lib.lsplm_sparse_scatter_max_warps.argtypes = [i32]
    lib.lsplm_sparse_scatter_max_warps.restype = i32
    lib.lsplm_scatter_error_string.argtypes = [i32]
    lib.lsplm_scatter_error_string.restype = ctypes.c_char_p
    return lib


def _check(layout, vals, dz) -> None:
    name = "lsplm_sparse_scatter"
    if dz.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dz.device} "
                         "(the plain versions in ops.py serve CPU tensors)")
    tables = [getattr(layout, f) for f in _TABLES]
    if any(t.device != dz.device for t in (*tables, vals)):
        raise ValueError(f"{name}: every tensor must lie on {dz.device}")
    if any(t.dtype != torch.int32 for t in tables):
        raise ValueError(f"{name}: the layout's tables must be int32")
    if vals.dtype != torch.float32 or dz.dtype != torch.float32:
        raise ValueError(f"{name}: vals and dz must be float32, got "
                         f"{vals.dtype}/{dz.dtype}")
    if any(t.ndim != 1 for t in (*tables, vals)):
        raise ValueError(f"{name}: the layout's tables and vals must be 1-D")
    (task_piece_start, piece_start, piece_run, run_piece_start, row_ids,
     order, sample_sorted, inv_sorted) = tables
    kept = order.numel()
    if (piece_start.numel() != piece_run.numel() + 1
            or run_piece_start.numel() < 1 or inv_sorted.numel() < 1
            or task_piece_start.numel() < 1
            or not row_ids.numel() == sample_sorted.numel() == kept
            or vals.numel() != layout.num_entries):
        raise ValueError(
            f"{name}: inconsistent sizes: piece_start {piece_start.numel()}, "
            f"piece_run {piece_run.numel()}, run_piece_start "
            f"{run_piece_start.numel()}, task_piece_start "
            f"{task_piece_start.numel()}, inv_sorted {inv_sorted.numel()}, "
            f"sorted entries {row_ids.numel()}/{kept}/"
            f"{sample_sorted.numel()}, vals {vals.numel()} of "
            f"{layout.num_entries} entries")
    if dz.ndim != 2 or not 1 <= dz.shape[1] <= _MAX_COLUMNS:
        raise ValueError(f"{name}: dz must be (N, 2m) with 2m <= "
                         f"{_MAX_COLUMNS}, got {tuple(dz.shape)}")
    if not all(t.is_contiguous() for t in (*tables, vals, dz)):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if max(kept, vals.numel(), dz.numel(), piece_run.numel(),
           inv_sorted.numel() * dz.shape[1]) >= 2**31:
        raise ValueError(f"{name}: sizes must fit in int32")


def warps_for(block_e: int | None) -> int:
    """Task warps a block for ``block_e`` sorted entries (None: the
    default); raises ``ValueError`` for a ``block_e`` the kernel has no
    block for. Whether its buffers fit is the launch's to check."""
    block_e = DEFAULT_BLOCK_E if block_e is None else block_e
    if block_e not in BLOCK_E_GRID:
        raise ValueError(f"block_e must be one of {BLOCK_E_GRID} (32 sorted "
                         f"entries a task warp), got {block_e!r}")
    return block_e // 32


def max_block_e(m2: int) -> int:
    """The largest ``block_e`` whose dz row buffers fit a block's shared
    memory at 2m columns, as the .cu lays a block out (card only: it asks
    the built library)."""
    return 32 * _lib().lsplm_sparse_scatter_max_warps(m2)


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed ticket buffer of ``stream``, at least ``n`` long."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1), dtype=torch.int32,
                                        device=device)
    return t


def lsplm_sparse_scatter(layout, vals: torch.Tensor, dz: torch.Tensor, *,
                         block_e: int | None = None) -> torch.Tensor:
    """The dense dTheta (D, 2m) fp32 on the card: row r is the sum of
    ``vals[order[e]] * dz[sample_sorted[e]]`` over the sorted entries e of
    id r, every untouched row (the pad row included) exactly 0.

    ``layout`` is a :class:`~.plan.TransposePlan` or an
    ``ops.RunLayout`` on ``dz``'s device: its int32 tables (``_TABLES``)
    and ``num_entries``; D = ``inv_sorted.numel()``. ``vals`` is the
    batch's (N*K,) flat float32 values, ``dz`` the (N, 2m) float32
    upstream gradient, both contiguous. ``block_e`` as in the module
    docstring."""
    _check(layout, vals, dz)
    num_rows, m2 = layout.inv_sorted.numel(), dz.shape[1]
    warps = warps_for(block_e)
    num_unique = layout.run_piece_start.numel() - 1
    num_pieces = layout.piece_run.numel()
    out = torch.empty((num_rows, m2), dtype=torch.float32, device=dz.device)
    partial = torch.empty((max(num_pieces, 1), m2), dtype=torch.float32,
                          device=dz.device)
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    ticket = _tickets(dz.device, stream, num_unique)
    rc = _lib().lsplm_sparse_scatter(
        *(getattr(layout, f).data_ptr() for f in _TABLES), vals.data_ptr(),
        dz.data_ptr(), partial.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        layout.task_piece_start.numel() - 1, num_rows, num_unique, m2, warps,
        stream)
    if rc == OVER_BUDGET:
        raise ValueError(
            f"block_e={32 * warps} does not fit at 2m={m2}: its warps' dz "
            f"row buffers exceed the shared memory a block may use; take "
            f"block_e <= {max_block_e(m2)}")
    if rc != 0:
        msg = _lib().lsplm_scatter_error_string(rc).decode()
        raise RuntimeError(f"lsplm_sparse_scatter: kernel launch failed: "
                           f"{msg} ({rc})")
    LAUNCHES["lsplm_sparse_scatter"] += 1
    return out
