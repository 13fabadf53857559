"""Launch wrapper of the flash attention forward kernel (CUDA, B6).

The kernel lives in ``csrc/flash_attention.cu`` (see its header for the
design and what bounds it) and replaces the Pallas kernel of
``repro/kernels/flash_attention/flash_attention.py``. The wrapper checks
its tensors and calls the operator ``torch.ops.repro_torch.flash_attention``
(``kernels/_ops.py``), whose CUDA kernel allocates the output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to
:data:`LAUNCHES`; under ``FakeTensorMode`` its fake gives the output's
shape instead (the dry run). It has no backward, so it
refuses an input that requires a gradient under grad mode
(``ops.causal_attention`` is the differentiable entry).

q is (B, S, H, hd); k and v are the KV-head-sized (B, S, KVH, hd) tensors
(H % KVH == 0), not GQA-repeated copies: the kernel reads KV head
h // (H // KVH) for query head h. All three are read through their
strides as long as the head dim is unit-stride (a strided view of the
projections goes as it lies; anything else is made contiguous first).
bf16 at hd != 8 runs on the tensor cores and reads its operands by TMA,
which also wants 16-byte aligned bases and (batch, position, head)
strides that are multiples of 16 bytes: :func:`kernel_strides` gives
the strides the kernel is handed, and a tensor that fails those rules is
copied (:func:`tma_ready`). Any S works: the kernel masks the ragged
last tile. CUDA tensors only; ``ops.plain_attention`` serves CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _ops, refuse_grad

# launches of the wrapper, for runs that must show they went through the
# kernel (reset by the caller, read after the run)
LAUNCHES = {"flash_attention": 0}

_SOURCE = "flash_attention"
HEAD_DIMS = (8, 16, 64, 80, 128)  # the kernel's instantiations
# bf16 at these head dims takes the tensor-core body (TMA + wgmma)
TENSOR_CORE_HEAD_DIMS = (16, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_forward.argtypes = ([ptr] * 4 + [i32] * 5
                                            + [i64] * 9 + [ctypes.c_float]
                                            + [i32] * 2 + [ptr])
    lib.flash_attention_forward.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """The rules the kernel and its plain version share: q (B, S, H, hd),
    k and v one (B, S, KVH, hd) shape with H % KVH == 0, all float32 or
    all bfloat16. Raises ``ValueError``."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q must be (B, S, H, hd) and k, v "
                         f"(B, S, KVH, hd), got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{name}: H = {q.shape[2]} must be a multiple of "
                         f"KVH = {k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must all be float32 or all "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")


def kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, position, head) element strides the kernel is handed
    for a (B, S, heads, hd) tensor with a unit-stride head dim: its own,
    except that a dimension of size 1 gets the stride of a packed layout
    (PyTorch may give such a dimension any stride; TMA checks every
    stride it is given)."""
    B, S, heads, hd = t.shape
    sb, ss, sh = t.stride()[:3]
    if heads == 1:
        sh = hd
    if S == 1:
        ss = heads * sh
    if B == 1:
        sb = S * ss
    return sb, ss, sh


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the tensor-core body can read ``t`` (bf16) in place: a
    16-byte aligned base and strides (:func:`kernel_strides`) that are
    positive multiples of 16 bytes."""
    vec = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(s > 0 and s % vec == 0 for s in kernel_strides(t)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k, v (B, S, KVH, hd) on the card,
    causal or not. Returns a contiguous (B, S, H, hd) tensor in q's
    dtype."""
    name = "flash_attention"
    refuse_grad(name, "ops.causal_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {q.device} "
                         "(ops.plain_attention serves CPU tensors)")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k and v must share one device, got "
                         f"{q.device}/{k.device}/{v.device}")
    check_inputs(name, q, k, v)
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS} (the "
                         "kernel's instantiations)")
    if B > 65535 or H > 65535 or S >= 2**31:
        raise ValueError(f"{name}: B and H must be <= 65535 and S < 2^31")
    return _OP(q, k, v, bool(causal))


def _launch(q, k, v, causal):
    """The operator's CUDA kernel: the launch, on checked tensors."""
    name = "flash_attention"
    B, S, H, hd = q.shape
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B * S * H == 0:
        return o
    if q.dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        q, k, v = (t if tma_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], hd, *kernel_strides(q), *kernel_strides(k),
        *kernel_strides(v), hd ** -0.5, int(causal), _DTYPES[q.dtype],
        stream)
    if rc != 0:
        msg = _lib().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return o


def _fake(q, k, v, causal):
    return q.new_empty(q.shape)


def _flops(q, k, v, causal, out_shape=None) -> int:
    """4 B H S_q S_k hd (the two products), halved when causal."""
    B, S, H, hd = q
    return 4 * B * H * S * k[1] * hd // (2 if causal else 1)


def _hbm_bytes(q, k, v, causal) -> int:
    """q, k and v read once, the output written once."""
    return _ops.nbytes(q, k, v, q)


_OP = _ops.define("flash_attention", "(Tensor q, Tensor k, Tensor v, "
                  "bool causal) -> Tensor", _launch, _fake, _flops,
                  _hbm_bytes)
