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

The gated mode's gradient is a kernel of its own, ``csrc/mamba_scan_bwd.cu``
(see its header), one more entry point:

* :func:`mamba1_scan_gated_backward` takes the gated mode's inputs and
  the output gradients dy (in x's dtype) and dhT (fp32), either None,
  and returns every input's gradient in that input's dtype, None where
  ``needs`` says no (``ops.gated_selective_scan`` 's Function calls it).

Each wrapper checks its tensors and calls its operator,
``torch.ops.repro_torch.mamba1_scan``, ``...mamba1_scan_gated`` or
``...mamba1_scan_gated_backward`` (``kernels/_ops.py``), whose CUDA
kernel picks G (the forward's), allocates its outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its key
of :data:`LAUNCHES`; under ``FakeTensorMode`` its fake gives the outputs'
shapes instead (the dry run). The backward's operator returns the
kernel's partial sums and its checkpoint workspace, and the wrapper adds
the partials up with torch's sum (glue). None of the three is itself
differentiable, so each refuses an input that requires a gradient under
grad mode (``ops.gated_selective_scan`` is the differentiable entry of
the gated mode, ``ops.plain_scan`` the contract's). x, B_in and C_in are float32 or bfloat16; every
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
import math

import torch

from repro_torch.kernels import _build, _ops, refuse_grad

# launches of each wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"mamba1_scan": 0, "mamba1_scan_gated": 0,
            "mamba1_scan_gated_backward": 0}

_SOURCE = "mamba_scan"
_BWD_SOURCE = "mamba_scan_bwd"
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
# the backward kernel: a thread a channel, BWD_THREADS channels a block;
# the states it keeps for a chunk of steps fill _BWD_STATE_FLOATS, at
# most 16 steps (csrc/mamba_scan_bwd.cu chunk_steps)
BWD_THREADS = 128
_BWD_STATE_FLOATS = 16384
# input order of the gated mode; bit i of the backward's ``needs``
GATED_INPUTS = ("dt_raw", "dt_bias", "x", "B_in", "C_in", "A_log", "D",
                "z", "h0")


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
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba1_scan_gated_backward.argtypes = ([ptr] * 20 + [i32] * 4
                                               + [i64] * 12 + [i32, ptr])
    lib.mamba1_scan_gated_backward.restype = i32
    lib.mamba1_scan_gated_backward_chunk.argtypes = [i32]
    lib.mamba1_scan_gated_backward_chunk.restype = i32
    lib.mamba1_scan_gated_backward_error_string.argtypes = [i32]
    lib.mamba1_scan_gated_backward_error_string.restype = ctypes.c_char_p
    for n in STATE_SIZES:
        if lib.mamba1_scan_gated_backward_chunk(n) != backward_chunk(n):
            raise RuntimeError(f"{_BWD_SOURCE}: the kernel's chunk at N = "
                               f"{n} is not backward_chunk's")
    return lib


def backward_chunk(N: int) -> int:
    """Steps of one chunk of the backward kernel at state size N: its
    workspace keeps the state entering every this-many steps."""
    return min(16, _BWD_STATE_FLOATS // (BWD_THREADS * N))


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


def _check_group(name, x, N, group) -> int:
    """The operator's ``group`` argument for checked inputs: ``group``
    itself, or 0 when None (the CUDA kernel picks G from B * di, the
    steps and the card's SMs, :func:`threads_per_channel`)."""
    if N not in STATE_SIZES:
        raise ValueError(f"{name}: state size N = {N} not in {STATE_SIZES} "
                         "(the kernel's instantiations)")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: B must be <= 65535")
    if group is None:
        return 0
    if group not in GROUPS or group > N:
        raise ValueError(f"{name}: group = {group} not in {GROUPS} or "
                         f"above N = {N}")
    return group


def _group(x, N, group) -> int:
    """G for a launch: ``group``, or from the card when 0."""
    if group:
        return group
    return threads_per_channel(x.shape[0] * x.shape[2], x.shape[1],
                               _sm_count(x.device), N)


def _rows(*tensors):
    """Each (B, S, .) operand as the kernel reads it (unit-stride last
    dim) with its batch and position strides."""
    out, strides = [], []
    for t in tensors:
        t = t if t.stride(2) == 1 else t.contiguous()
        out.append(t)
        strides += t.stride()[:2]
    return out, strides


def _finish(name, rc, error_string=None):
    if rc != 0:
        msg = (error_string or _lib().mamba1_scan_error_string)(rc).decode()
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
    group = _check_group(name, x, B_in.shape[2], group)
    return _SCAN(dt, x, B_in, C_in, A, D, h0, group)


def _launch_scan(dt, x, B_in, C_in, A, D, h0, group):
    """The contract operator's CUDA kernel: the launch, on checked
    tensors."""
    N = B_in.shape[2]
    G = _group(x, N, group)
    if B_in.dtype != x.dtype:  # one type for all three: widen (exact)
        x, B_in, C_in = (t.float() for t in (x, B_in, C_in))
    Bb, S, di = x.shape
    (dt, x, B_in, C_in), strides = _rows(dt, x, B_in, C_in)
    A, D = A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=x.device)
    hT = torch.empty((Bb, di, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _finish("mamba1_scan", _lib().mamba1_scan_forward(
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
    group = _check_group(name, x, B_in.shape[2], group)
    return _GATED(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, group)


def _launch_gated(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, group):
    """The gated operator's CUDA kernel: the launch, on checked
    tensors."""
    N = B_in.shape[2]
    G = _group(x, N, group)
    Bb, S, di = x.shape
    (dt_raw, x, z, B_in, C_in), strides = _rows(dt_raw, x, z, B_in, C_in)
    dt_bias, A_log, D = (t.contiguous() for t in (dt_bias, A_log, D))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=x.dtype, device=x.device)
    hT = torch.empty((Bb, di, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _finish("mamba1_scan_gated", _lib().mamba1_scan_gated_forward(
        dt_raw.data_ptr(), dt_bias.data_ptr(), x.data_ptr(),
        B_in.data_ptr(), C_in.data_ptr(), A_log.data_ptr(), D.data_ptr(),
        z.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), Bb, S, di, N, G, *strides, _DTYPES[x.dtype], stream))
    return y, hT


def check_gated_backward_inputs(name: str, args, dy, dhT) -> None:
    """The rules the gated backward kernel and its plain version share:
    the gated mode's inputs ``args``, dy (B, S, di) in x's dtype and dhT
    (B, di, N) fp32, either None. Raises ``ValueError``."""
    check_gated_inputs(name, *args)
    x, B_in = args[2], args[3]
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"{name}: dy must be x's shape and dtype "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    want = (x.shape[0], x.shape[2], B_in.shape[2])
    if dhT is not None and dhT.shape != want:
        raise ValueError(f"{name}: dhT must be (B, di, N) = {want}, got "
                         f"{tuple(dhT.shape)}")
    _check_f32(name, "dhT", [dhT])


def needs_mask(needs, h0) -> int:
    """The operator's ``needs``: bit i set when input i (GATED_INPUTS'
    order) wants a gradient; h0's bit only when h0 is given."""
    needs = (True,) * len(GATED_INPUTS) if needs is None else tuple(needs)
    if len(needs) != len(GATED_INPUTS):
        raise ValueError(f"needs: one bool per input {GATED_INPUTS}, got "
                         f"{len(needs)}")
    mask = sum(1 << i for i, need in enumerate(needs) if need)
    return mask if h0 is not None else mask & ~(1 << 8)


def mamba1_scan_gated_backward(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z,
                               h0, dy, dhT, *, needs=None):
    """The gated scan's gradients on the card: for the output gradients dy
    (of y, in x's dtype) and dhT (of hT, fp32), either None, a tuple with
    one entry per input (GATED_INPUTS), None where the input is None or
    its ``needs`` entry is false (``needs``: one bool per input, default
    all). Each is in its input's dtype but dB_in and dC_in, the sums over
    channels, which stay fp32 (``ops._GatedScan`` rounds them to B_in's
    dtype). One launch of the backward kernel, then torch sums of its
    partials. Its plain version is ``ops.plain_gated_scan_backward``."""
    name = "mamba1_scan_gated_backward"
    args = (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    refuse_grad(name, "ops.gated_scan_backward_plain", *args, dy, dhT)
    _on_card(name, x, [dt_raw, dt_bias, B_in, C_in, A_log, D, z, h0, dy,
                       dhT])
    check_gated_backward_inputs(name, args, dy, dhT)
    _check_group(name, x, B_in.shape[2], None)
    mask = needs_mask(needs, h0)
    grads = [None] * len(GATED_INPUTS)
    if not mask or (dy is None and dhT is None):
        return tuple(grads)
    dy = torch.zeros_like(x) if dy is None else dy
    ddt_raw, dx, dz, dh0, part_bc, part_A, part_D, part_bias, _ = \
        _GATED_BWD(*args, dy, dhT, mask)
    out = {0: ddt_raw, 2: dx, 7: dz, 8: dh0}
    if part_bc.numel():  # the block partials, summed: (B, S, 2N) fp32
        N = B_in.shape[2]
        bc = part_bc.sum(2)
        out[3], out[4] = bc[..., :N], bc[..., N:]
    if part_A.numel():
        out[5] = -torch.exp(A_log) * part_A.sum(0)
    if part_D.numel():
        out[6] = part_D.sum(0)
    if part_bias.numel():
        out[1] = part_bias.sum(0)
    for i, g in out.items():
        if mask >> i & 1:
            grads[i] = g if i in (3, 4) else g.to(args[i].dtype)
    return tuple(grads)


def _backward_shapes(x_shape, x_dtype, N, needs):
    """(shape, dtype) of the backward operator's outputs, in order:
    ddt_raw, dx, dz (B, S, di) in x's dtype; dh0 (B, di, N); the block
    partials of dB and dC (B, S, ceil(di / BWD_THREADS), 2N); those of
    dA_log (B, di, N), dD and ddt_bias (B, di); the checkpoint workspace
    (B, ceil(S / backward_chunk(N)), di, N); all but the first three
    fp32. An output no ``needs`` bit asks for is (0,)."""
    Bb, S, di = x_shape
    f32 = torch.float32
    blocks = -(-di // BWD_THREADS)
    chunks = -(-S // backward_chunk(N))

    def out(bits, shape, dtype=f32):
        return (shape if any(needs >> i & 1 for i in bits) else (0,), dtype)

    return [out((0,), (Bb, S, di), x_dtype), out((2,), (Bb, S, di), x_dtype),
            out((7,), (Bb, S, di), x_dtype), out((8,), (Bb, di, N)),
            out((3, 4), (Bb, S, blocks, 2 * N)), out((5,), (Bb, di, N)),
            out((6,), (Bb, di)), out((1,), (Bb, di)),
            ((Bb, chunks, di, N), f32)]


def _backward_outputs(x, N, needs):
    """The backward operator's outputs (:func:`_backward_shapes`),
    uninitialised, on x's device."""
    return tuple(x.new_empty(shape, dtype=dtype) for shape, dtype in
                 _backward_shapes(x.shape, x.dtype, N, needs))


def _launch_gated_backward(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0,
                           dy, dhT, needs):
    """The backward operator's CUDA kernel: the launch, on checked
    tensors."""
    N = B_in.shape[2]
    Bb, S, di = x.shape
    (dt_raw, x, z, B_in, C_in, dy), strides = _rows(dt_raw, x, z, B_in,
                                                    C_in, dy)
    dt_bias, A_log, D = (t.contiguous() for t in (dt_bias, A_log, D))
    h0, dhT = (None if t is None else t.contiguous() for t in (h0, dhT))
    outs = _backward_outputs(x, N, needs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _bwd_lib()

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    # the kernel's stride order: dt_raw, x, z, B, C, dy
    _finish("mamba1_scan_gated_backward", lib.mamba1_scan_gated_backward(
        *(ptr(t) for t in (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0,
                           dy, dhT)), outs[8].data_ptr(),
        *(ptr(t) for t in outs[:8]), Bb, S, di, N, *strides,
        _DTYPES[x.dtype], stream), lib.mamba1_scan_gated_backward_error_string)
    return outs


def _fake_gated_backward(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0,
                         dy, dhT, needs):
    return _backward_outputs(x, B_in.shape[2], needs)


def _gated_backward_flops(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0,
                          dy, dhT, needs, out_shape=None) -> int:
    """32 B S di N: the forward's state update twice (pass 1 and the
    chunk's recompute, 5 a state-step: dt A, its exponential, the two
    products and their sum) and the walk's 22 (the update again, h C and
    its fold, the adjoint's product and sum, g B, g (da h), A times it
    and their folds, the dA_log sum's product and sum, the dB and dC
    terms and their sums, the carried da g)."""
    Bb, S, di = x
    return 32 * Bb * S * di * B_in[2]


def _gated_backward_bytes(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0,
                          dy, dhT, needs) -> int:
    """Every input read once, every output written once, and the
    checkpoint workspace read back once."""
    outs = [math.prod(shape) * dtype.itemsize for shape, dtype in
            _backward_shapes(x.shape, x.dtype, B_in.shape[2], needs)]
    return (_ops.nbytes(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, dy,
                        dhT) + sum(outs) + outs[-1])


def _fake_scan(dt, x, B_in, C_in, A, D, h0, group):
    Bb, S, di = x.shape
    return (x.new_empty((Bb, S, di), dtype=torch.float32),
            x.new_empty((Bb, di, B_in.shape[2]), dtype=torch.float32))


def _fake_gated(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, group):
    Bb, S, di = x.shape
    return (x.new_empty((Bb, S, di)),
            x.new_empty((Bb, di, B_in.shape[2]), dtype=torch.float32))


def _flops(x_shape, N) -> int:
    """The reference's count of a selective scan, 8 B S di N: the decay
    and its exponential, the state's update and the read-out's
    multiply-add (``repro/launch/dryrun.py`` ``_ssm_scan_corrections``)."""
    Bb, S, di = x_shape
    return 8 * Bb * S * di * N


def _scan_flops(dt, x, B_in, C_in, A, D, h0, group, out_shape=None) -> int:
    return _flops(x, B_in[2])


def _gated_flops(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, group,
                 out_shape=None) -> int:
    return _flops(x, B_in[2])


def _scan_bytes(dt, x, B_in, C_in, A, D, h0, group) -> int:
    """Every input read once, y and hT written once."""
    Bb, S, di = x.shape
    return _ops.nbytes(dt, x, B_in, C_in, A, D, h0) + 4 * Bb * di * (
        S + B_in.shape[2])


def _gated_bytes(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0,
                 group) -> int:
    """Every input read once, y (x's dtype) and hT written once."""
    Bb, S, di = x.shape
    return (_ops.nbytes(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, x)
            + 4 * Bb * di * B_in.shape[2])


_SCAN = _ops.define(
    "mamba1_scan", "(Tensor dt, Tensor x, Tensor B_in, Tensor C_in, "
    "Tensor A, Tensor D, Tensor? h0, int group) -> (Tensor, Tensor)",
    _launch_scan, _fake_scan, _scan_flops, _scan_bytes)
_GATED = _ops.define(
    "mamba1_scan_gated", "(Tensor dt_raw, Tensor dt_bias, Tensor x, "
    "Tensor B_in, Tensor C_in, Tensor A_log, Tensor D, Tensor z, "
    "Tensor? h0, int group) -> (Tensor, Tensor)", _launch_gated,
    _fake_gated, _gated_flops, _gated_bytes)
_GATED_BWD = _ops.define(
    "mamba1_scan_gated_backward", "(Tensor dt_raw, Tensor dt_bias, "
    "Tensor x, Tensor B_in, Tensor C_in, Tensor A_log, Tensor D, Tensor z, "
    "Tensor? h0, Tensor dy, Tensor? dhT, int needs) -> (Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _launch_gated_backward, _fake_gated_backward, _gated_backward_flops,
    _gated_backward_bytes)
