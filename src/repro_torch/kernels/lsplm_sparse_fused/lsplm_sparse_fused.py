"""Launch wrappers of the fused sparse LS-PLM forward kernels (CUDA).

The kernels live in ``csrc/lsplm_sparse_fused.cu`` (see its header for
the design, what bounds it and its bitwise contract) and replace the two
Pallas kernels of ``repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py``.
Each wrapper checks its arguments (shapes first, so the checks run on any
device, then CUDA, dtypes, contiguity), allocates the outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its
entry in :data:`LAUNCHES`.

Options of both wrappers:

  * ``dedup=True`` collapses duplicate ids within each row inside the
    kernel, bitwise what ``ops.dedup_tile_ids`` followed by the kernel
    with ``dedup=False`` gives; rows may then carry at most
    :data:`MAX_DEDUP_K` slots (more raises ``ValueError``);
  * ``z_add`` (G, 2m) float32 with ``session`` (N,) int32 or int64:
    z[n] = z_add[session[n]] + the row's own sum, bitwise
    ``z_add.index_select(0, session) + z``. A session outside [0, G)
    adds a zero row, like the pad (no range check: that would cost a
    device sync per call);
  * ``head=False`` skips the Eq. 2 head; p is then None;
  * ``block_n`` (rows a block, one warp a row: 1, 2, 4 or 8) and, for
    fp32 rows, ``copy`` (``COPY_LANE``: lane t copies entry t's row;
    ``COPY_PIECE``: neighbouring lanes copy one row's pieces) set the
    launch (:func:`launch_config`). None takes the rule every launch
    had before the tune table, which the .cu keeps with its shared-memory
    layout: rows a block by N, halved while over the 48 KB budget, and by
    piece at N >= 2,048. Neither changes a row's bits. An explicit
    ``block_n`` the budget cannot hold raises ``ValueError``
    (:func:`max_block_n`); it is never shrunk. The callers in ``ops.py``
    pass what ``repro_torch.tune`` resolves.

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
from repro_torch.tune.table import COPY_LANE, COPY_PIECE

# launches per wrapper, for runs that must show they went through the
# kernels (reset by the caller, read after the run)
LAUNCHES = {"lsplm_sparse_fused_forward": 0,
            "lsplm_sparse_fused_int8_forward": 0}

_SOURCE = "lsplm_sparse_fused"
_MAX_COLUMNS = 128  # the kernel keeps at most 4 x 32 columns per lane
MAX_DEDUP_K = 1024  # slots per row with dedup=True (kMaxDedupK in the .cu)
BLOCK_N_GRID = (1, 2, 4, 8)  # rows a block the kernel takes
OVER_BUDGET = -1  # the launch's refusal of a block_n (kOverBudget)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call
    builds the source if needed)."""
    lib = _build.load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [ptr, ptr, i32, i32, ptr, ptr] + [i32] * 7 + [ptr]
    lib.lsplm_sparse_fused_forward.argtypes = [ptr] * 3 + tail
    lib.lsplm_sparse_fused_forward.restype = i32
    lib.lsplm_sparse_fused_int8_forward.argtypes = [ptr] * 4 + tail
    lib.lsplm_sparse_fused_int8_forward.restype = i32
    lib.lsplm_sparse_fused_max_warps.argtypes = [i32] * 4
    lib.lsplm_sparse_fused_max_warps.restype = i32
    lib.lsplm_sparse_fused_rule.argtypes = [i32] * 5 + [ptr, ptr]
    lib.lsplm_sparse_fused_rule.restype = None
    lib.lsplm_cuda_error_string.argtypes = [i32]
    lib.lsplm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, ids: torch.Tensor, vals: torch.Tensor,
           rows: torch.Tensor, rows_dtype: torch.dtype, dedup: bool,
           z_add: torch.Tensor | None, session: torch.Tensor | None) -> None:
    if ids.ndim != 2 or ids.shape != vals.shape:
        raise ValueError(f"{name}: ids/vals must be (N, K), got "
                         f"{tuple(ids.shape)}/{tuple(vals.shape)}")
    if (rows.ndim != 2 or rows.shape[1] % 2 or rows.shape[0] < 1
            or not 2 <= rows.shape[1] <= _MAX_COLUMNS):
        raise ValueError(f"{name}: rows must be (D, 2m) with D >= 1 and "
                         f"2 <= 2m <= {_MAX_COLUMNS}, got {tuple(rows.shape)}")
    if dedup and ids.shape[1] > MAX_DEDUP_K:
        raise ValueError(f"{name}: dedup=True takes at most {MAX_DEDUP_K} "
                         f"slots per row, got K = {ids.shape[1]}")
    if (z_add is None) != (session is None):
        raise ValueError(f"{name}: z_add and session go together")
    if z_add is not None:
        if z_add.ndim != 2 or z_add.shape[0] < 1 \
                or z_add.shape[1] != rows.shape[1]:
            raise ValueError(f"{name}: z_add must be (G, {rows.shape[1]}) "
                             f"with G >= 1, got {tuple(z_add.shape)}")
        if tuple(session.shape) != (ids.shape[0],):
            raise ValueError(f"{name}: session must be ({ids.shape[0]},), "
                             f"got {tuple(session.shape)}")
        if z_add.dtype != torch.float32 or session.dtype not in (
                torch.int32, torch.int64):
            raise ValueError(f"{name}: z_add must be float32 and session "
                             f"int32 or int64, got {z_add.dtype}/"
                             f"{session.dtype}")
    if ids.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {ids.device} "
                         "(the plain version in ops.py serves CPU tensors)")
    extra = () if z_add is None else (z_add, session)
    if any(t.device != ids.device for t in (vals, rows, *extra)):
        raise ValueError(f"{name}: ids, vals, rows, z_add and session must "
                         f"share one device")
    if ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise ValueError(f"{name}: ids must be int32 and vals float32, got "
                         f"{ids.dtype}/{vals.dtype}")
    if rows.dtype != rows_dtype:
        raise ValueError(f"{name}: rows must be {rows_dtype}, got {rows.dtype}")
    if not all(t.is_contiguous() for t in (ids, vals, rows, *extra)):
        raise ValueError(f"{name}: ids, vals, rows, z_add and session must "
                         "be contiguous")
    if ids.numel() >= 2**31 or rows.shape[0] >= 2**31:
        raise ValueError(f"{name}: sizes must fit in int32")


def _knob_args(block_n: int | None, copy: int | None, *,
               int8: bool) -> tuple[int, int]:
    """(warps, by_piece) as the C launch takes them: 0 and -1 take the
    rule. Raises ``ValueError`` for a ``block_n`` off :data:`BLOCK_N_GRID`
    or a ``copy`` the variant does not have; the budget is the launch's
    to check."""
    if block_n is not None and block_n not in BLOCK_N_GRID:
        raise ValueError(f"block_n must be one of {BLOCK_N_GRID} (rows a "
                         f"block, one warp a row), got {block_n!r}")
    if int8 and copy not in (None, COPY_LANE):
        raise ValueError(f"copy={copy!r}: int8 rows are always copied "
                         f"lane per row (COPY_LANE = {COPY_LANE})")
    if copy not in (None, COPY_LANE, COPY_PIECE):
        raise ValueError(f"copy must be COPY_LANE ({COPY_LANE}) or "
                         f"COPY_PIECE ({COPY_PIECE}), got {copy!r}")
    return (0 if block_n is None else block_n,
            -1 if copy is None else int(copy == COPY_PIECE))


def max_block_n(k: int, m2: int, *, int8: bool, dedup: bool) -> int:
    """The most rows a block the 48 KB shared-memory budget holds at K
    slots and 2m columns, as the .cu lays a block out (card only: it
    asks the built library)."""
    return _lib().lsplm_sparse_fused_max_warps(k, m2 // 2, int(int8),
                                                int(dedup))


def launch_config(n: int, k: int, m2: int, *, int8: bool, dedup: bool,
                  block_n: int | None = None,
                  copy: int | None = None) -> tuple[int, int]:
    """(rows a block, copy scheme) a launch at N rows, K slots and 2m
    columns takes (card only: it asks the built library). A knob left
    None takes the .cu's rule: 1, 2, 4 or 8 rows a block at N <= 132,
    264, 528 or above (small N spreads rows over the SMs), halved while
    over the budget; fp32 rows by piece at N >= 2,048, where they are
    bandwidth-bound, and int8 rows always lane per row. A given knob is
    checked as a launch checks it: off the grid, over the budget, or a
    ``copy`` the variant does not have raises ``ValueError``."""
    warps, by_piece = _knob_args(block_n, copy, int8=int8)
    rule_warps, rule_piece = ctypes.c_int(), ctypes.c_int()
    _lib().lsplm_sparse_fused_rule(n, k, m2 // 2, int(int8), int(dedup),
                                   ctypes.byref(rule_warps),
                                   ctypes.byref(rule_piece))
    if warps == 0:
        warps = rule_warps.value
    elif warps > max_block_n(k, m2, int8=int8, dedup=dedup):
        _raise_over_budget(warps, k, m2, int8=int8, dedup=dedup)
    piece = rule_piece.value if by_piece < 0 else by_piece
    return warps, COPY_PIECE if piece else COPY_LANE


def _raise_over_budget(block_n: int, k: int, m2: int, *, int8: bool,
                 dedup: bool):
    raise ValueError(
        f"block_n={block_n} does not fit: {block_n} rows a block exceed "
        f"the shared memory a block may use at K={k}, 2m={m2}"
        f"{', int8' if int8 else ''}{', dedup' if dedup else ''}; take "
        f"block_n <= {max_block_n(k, m2, int8=int8, dedup=dedup)}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().lsplm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")


def _launch(name, fn, ids, vals, row_ptrs, rows, dedup, z_add, session,
            head, block_n, copy):
    """Allocate (p, z), launch ``fn`` on the current stream, count it."""
    n, k = ids.shape
    d, m2 = rows.shape
    int8 = rows.dtype == torch.int8
    warps, by_piece = _knob_args(block_n, copy, int8=int8)
    p = (torch.empty((n,), dtype=torch.float32, device=ids.device)
         if head else None)
    z = torch.empty((n, m2), dtype=torch.float32, device=ids.device)
    if n == 0:
        return p, z
    addend = (None, None, 0, 0) if z_add is None else (
        z_add.data_ptr(), session.data_ptr(),
        int(session.dtype == torch.int64), z_add.shape[0])
    rc = fn(ids.data_ptr(), vals.data_ptr(), *row_ptrs, *addend,
            None if p is None else p.data_ptr(), z.data_ptr(), n, k, d,
            m2 // 2, int(dedup), warps, by_piece,
            torch.cuda.current_stream(ids.device).cuda_stream)
    if rc == OVER_BUDGET:
        _raise_over_budget(block_n, k, m2, int8=int8, dedup=dedup)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return p, z


def lsplm_sparse_fused_forward(ids: torch.Tensor, vals: torch.Tensor,
                               theta: torch.Tensor, *, dedup: bool = False,
                               z_add: torch.Tensor | None = None,
                               session: torch.Tensor | None = None,
                               head: bool = True, block_n: int | None = None,
                               copy: int | None = None
                               ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Fused fp32 forward on the card. ids (N, K) int32 with pad id
    D-1, vals (N, K) float32, theta (D, 2m) float32 with its zero pad
    row; options as in the module docstring. Returns (p (N,) or None,
    z (N, 2m)) float32."""
    name = "lsplm_sparse_fused_forward"
    _check(name, ids, vals, theta, torch.float32, dedup, z_add, session)
    return _launch(name, _lib().lsplm_sparse_fused_forward, ids, vals,
                   (theta.data_ptr(),), theta, dedup, z_add, session, head,
                   block_n, copy)


def lsplm_sparse_fused_int8_forward(ids: torch.Tensor, vals: torch.Tensor,
                                    codes: torch.Tensor, scales: torch.Tensor,
                                    *, dedup: bool = False,
                                    z_add: torch.Tensor | None = None,
                                    session: torch.Tensor | None = None,
                                    head: bool = True,
                                    block_n: int | None = None
                                    ) -> tuple[torch.Tensor | None,
                                               torch.Tensor]:
    """Fused int8-native forward on the card: rows are ``codes[i] *
    scales[i]`` formed in registers (fp32 rows never exist). codes (D, 2m)
    int8 with its zero pad row, scales (D,) float32 (pad scale 0);
    options as in the module docstring. Returns (p (N,) or None, z (N,
    2m)) float32."""
    name = "lsplm_sparse_fused_int8_forward"
    _check(name, ids, vals, codes, torch.int8, dedup, z_add, session)
    if (scales.dtype != torch.float32 or scales.device != ids.device
            or tuple(scales.shape) != (codes.shape[0],)
            or not scales.is_contiguous()):
        raise ValueError(f"{name}: scales must be a contiguous float32 "
                         f"({codes.shape[0]},) tensor on {ids.device}, got "
                         f"{scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    return _launch(name, _lib().lsplm_sparse_fused_int8_forward, ids, vals,
                   (codes.data_ptr(), scales.data_ptr()), codes, dedup, z_add,
                   session, head, block_n, None)
