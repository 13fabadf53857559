"""The Mamba1 selective scan (B7) in the port against the JAX reference on
the same numpy inputs.

On the CPU the port's plain version (``ref.mamba1_scan_ref``, behind
``ops.selective_scan`` / ``ops.plain_scan``) is held against the
reference's Pallas kernel in interpret mode and its jnp oracle
``repro.kernels.mamba_scan.ref.mamba1_scan_ref``, at
``tests/test_kernels.py``'s bar: y and hT within rtol = atol = 2e-5.
bf16 outputs (the reference contract returns y in x's dtype) are held
within 8e-3, two bf16 ulps at |y| ~ 1. The gated mode's plain version
(``ops.plain_gated_scan``: softplus of dt, -exp(A_log), the scan, the
silu(z) gate) is held against the reference model's composition
(``repro/models/ssm.py::_mamba1_inner``) at the same bars. The CUDA
kernel's tests on a card are in ``tests/test_torch_mamba_scan_card.py``
(no JAX there, so the card's machine collects them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba_scan.mamba_scan import mamba1_scan as j_kernel
from repro.kernels.mamba_scan.ref import mamba1_scan_ref as j_ref
from repro_torch.kernels.mamba_scan import mamba_scan as tk
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import mamba1_scan_ref

TOL = 2e-5  # tests/test_kernels.py:175
BF16_TOL = 8e-3

j_ref_jit = jax.jit(j_ref)


def _inputs(seed, B, S, di, N, h0=False):
    """dt = softplus(normal), x, B, C normal, A = -exp(0.5 normal), D
    normal, h0 normal (or None), as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, di))).astype(np.float32)
    return [dt, f(B, S, di), f(B, S, N), f(B, S, N),
            -np.exp(0.5 * f(di, N)).astype(np.float32), f(di),
            f(B, di, N) if h0 else None]


def _torch(arrays, xbc_dtype=torch.float32, device="cpu"):
    out = [None if a is None else torch.from_numpy(a).to(device)
           for a in arrays]
    for i in (1, 2, 3):
        out[i] = out[i].to(xbc_dtype)
    return out


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _gated_inputs(seed, B, S, di, N, h0=False):
    """The gated scan's inputs as numpy float32: dt_raw 3 normal with
    every 7th value above softplus's threshold (20), dt_bias normal - 3,
    x, B, C normal, A_log 0.5 normal, D, z normal, h0 normal (or None)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt_raw = 3 * f(B, S, di)
    dt_raw.reshape(-1)[::7] = 21 + np.abs(dt_raw.reshape(-1)[::7])
    return [dt_raw, f(di) - 3, f(B, S, di), f(B, S, N), f(B, S, N),
            0.5 * f(di, N), f(di), f(B, S, di), f(B, di, N) if h0 else None]


def _gated_torch(arrays, dtype=torch.float32, device="cpu"):
    """dt_raw, x, B, C and z in ``dtype``; the rest float32."""
    out = [None if a is None else torch.from_numpy(a).to(device)
           for a in arrays]
    for i in (0, 2, 3, 4, 7):
        out[i] = out[i].to(dtype)
    return out


def _composition(t):
    """The model's unfused composition around the plain scan."""
    dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0 = t
    dt = F.softplus(dt_raw.float() + dt_bias)
    y, h = ops.plain_scan(dt, x, B_in, C_in, -torch.exp(A_log), D, h0)
    return (y * F.silu(z.float())).to(x.dtype), h


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------ plain vs reference
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S,di,N,bd", [(16, 32, 8, 16), (32, 64, 16, 64),
                                       (8, 16, 4, 8)])
def test_plain_matches_reference_kernel_and_oracle(S, di, N, bd, h0):
    """At tests/test_kernels.py:162-163's shapes, from zeros and from a
    carried state: the port's oracle and ops.selective_scan on CPU
    tensors against the reference's interpret-mode kernel and oracle."""
    arrays = _inputs(1, 2, S, di, N, h0)
    jy, jh = j_kernel(*_jax(arrays), block_d=bd, interpret=True)
    ry, rh = j_ref_jit(*_jax(arrays))
    y, h = mamba1_scan_ref(*_torch(arrays))
    oy, oh = ops.selective_scan(*_torch(arrays))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (2, S, di) and h.shape == (2, di, N)
    for want_y, want_h in ((jy, jh), (ry, rh)):
        _close(y, want_y)
        _close(h, want_h)
    assert torch.equal(oy, y) and torch.equal(oh, h)


def test_bf16_inputs():
    """x, B and C in bf16: the oracle returns y in bf16 as the
    reference's does; the plain route widens x (exactly) and returns the
    fp32 scan of the same values."""
    arrays = _inputs(2, 2, 24, 48, 8, h0=True)
    t = _torch(arrays, torch.bfloat16)
    j = _jax(arrays)
    for i in (1, 2, 3):
        j[i] = j[i].astype(jnp.bfloat16)
    ry, rh = j_ref_jit(*j)
    y, h = mamba1_scan_ref(*t)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y, ry, BF16_TOL)
    _close(h, rh)
    py, ph = ops.plain_scan(*t)
    wide = [a if a is None or a.dtype != torch.bfloat16 else a.float()
            for a in t]
    wy, wh = mamba1_scan_ref(*wide)
    assert py.dtype == torch.float32
    assert torch.equal(py, wy) and torch.equal(ph, wh)
    j[1] = j[1].astype(jnp.float32)
    fy, _ = j_ref_jit(*j)
    _close(py, fy)


def test_chained_halves_equal_one_call():
    """Scanning [0, S/2) then [S/2, S) with the carried state gives the
    full scan's bits in the port (the same ops in the same order), and
    the reference kernel's full scan within the bar."""
    arrays = _inputs(3, 1, 32, 16, 4)
    t = _torch(arrays)
    y_full, h_full = ops.selective_scan(*t)
    h = None
    ys = []
    for sl in (slice(0, 16), slice(16, 32)):
        y_p, h = ops.selective_scan(t[0][:, sl], t[1][:, sl], t[2][:, sl],
                                    t[3][:, sl], t[4], t[5], h)
        ys.append(y_p)
    assert torch.equal(torch.cat(ys, dim=1), y_full)
    assert torch.equal(h, h_full)
    jy, jh = j_kernel(*_jax(arrays), block_d=16, interpret=True)
    _close(y_full, jy)
    _close(h_full, jh)


def test_single_step_from_a_state():
    """S = 1 from h0, as decode runs it: one step of the recurrence."""
    arrays = _inputs(4, 3, 1, 40, 16, h0=True)
    dt, x, Bi, Ci, A, D, h0 = _torch(arrays)
    y, h = ops.selective_scan(dt, x, Bi, Ci, A, D, h0)
    da = torch.exp(dt[:, 0, :, None] * A)
    want_h = da * h0 + (dt[:, 0] * x[:, 0])[..., None] * Bi[:, 0, None, :]
    want_y = (want_h * Ci[:, 0, None, :]).sum(-1) + D * x[:, 0]
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    torch.testing.assert_close(y[:, 0], want_y, rtol=TOL, atol=TOL)
    ry, rh = j_ref_jit(*_jax(arrays))
    _close(y, ry)
    _close(h, rh)


def test_cpu_tensor_takes_the_plain_version():
    t = _torch(_inputs(5, 2, 6, 8, 4, h0=True))
    before = tk.LAUNCHES["mamba1_scan"]
    y, h = ops.selective_scan(*t)
    assert tk.LAUNCHES["mamba1_scan"] == before
    py, ph = ops.plain_scan(*t)
    assert torch.equal(y, py) and torch.equal(h, ph)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.mamba1_scan(*t)  # the kernel takes no CPU tensor
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.selective_scan(*meta)


def test_input_rules():
    dt, x, Bi, Ci, A, D, h0 = _torch(_inputs(6, 2, 5, 8, 4, h0=True))
    scan = ops.selective_scan
    with pytest.raises(ValueError, match=r"\(B, S, di\)"):
        scan(dt[:, :4], x, Bi, Ci, A, D)
    with pytest.raises(ValueError, match=r"\(B, S, N\)"):
        scan(dt, x, Bi[:, :4], Ci[:, :4], A, D)
    with pytest.raises(ValueError, match=r"\(B, S, N\)"):
        scan(dt, x, Bi, Ci[..., :2], A, D)
    with pytest.raises(ValueError, match=r"A must be"):
        scan(dt, x, Bi, Ci, A[:, :2], D)
    with pytest.raises(ValueError, match=r"h0 must be"):
        scan(dt, x, Bi, Ci, A, D, h0[:1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan(dt, x.double(), Bi, Ci, A, D)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan(dt, x, Bi.bfloat16(), Ci, A, D)
    with pytest.raises(ValueError, match="must be float32"):
        scan(dt.bfloat16(), x, Bi, Ci, A, D)
    with pytest.raises(ValueError, match="must be float32"):
        scan(dt, x, Bi, Ci, A, D, h0.double())


# ------------------------------------------------------------ gated mode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,N,h0", [(2, 24, 48, 8, True),
                                         (1, 17, 20, 16, False)])
def test_plain_gated_scan_is_the_unfused_composition(B, S, di, N, h0, dtype):
    """plain_gated_scan is softplus, plain_scan and the silu(z) gate,
    literally: bit for bit on the CPU, y in x's dtype."""
    t = _gated_torch(_gated_inputs(10, B, S, di, N, h0), getattr(torch, dtype))
    y, h = ops.plain_gated_scan(*t)
    wy, wh = _composition(t)
    assert y.dtype == t[2].dtype and h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    gy, gh = ops.gated_selective_scan(*t)
    assert torch.equal(gy, y) and torch.equal(gh, h)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", BF16_TOL)])
def test_plain_gated_scan_matches_reference_composition(dtype, tol):
    """Against the reference model's composition on the same numpy
    inputs: jax.nn.softplus, the reference oracle, jax.nn.silu gating
    (repro/models/ssm.py::_mamba1_inner); y within the dtype's bar, hT
    within 2e-5."""
    arrays = _gated_inputs(11, 2, 20, 32, 8, h0=True)
    t = _gated_torch(arrays, getattr(torch, dtype))
    j = _jax(arrays)
    jdt = getattr(jnp, dtype)
    for i in (0, 2, 3, 4, 7):
        j[i] = j[i].astype(jdt)
    dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0 = j
    f32 = jnp.float32
    dt = jax.nn.softplus(dt_raw.astype(f32) + dt_bias)
    ry, rh = j_ref_jit(dt, x.astype(f32), B_in, C_in, -jnp.exp(A_log), D, h0)
    ry = (ry * jax.nn.silu(z.astype(f32))).astype(jdt)
    y, h = ops.plain_gated_scan(*t)
    assert y.dtype == getattr(torch, dtype)
    _close(y, ry.astype(f32), tol)
    _close(h, rh)


def test_plain_gated_chained_halves_equal_one_call():
    t = _gated_torch(_gated_inputs(12, 2, 30, 16, 8), torch.bfloat16)
    y, h = ops.plain_gated_scan(*t)
    seq = (0, 2, 3, 4, 7)
    first, second = list(t), list(t)
    for i in seq:
        first[i], second[i] = t[i][:, :13], t[i][:, 13:]
    ya, ha = ops.plain_gated_scan(*first)
    second[8] = ha
    yb, hb = ops.plain_gated_scan(*second)
    assert torch.equal(torch.cat([ya, yb], dim=1), y) and torch.equal(hb, h)


def test_cpu_gated_takes_the_plain_version():
    t = _gated_torch(_gated_inputs(13, 2, 6, 8, 4, h0=True))
    before = dict(tk.LAUNCHES)
    y, h = ops.gated_selective_scan(*t)
    assert tk.LAUNCHES == before
    py, ph = ops.plain_gated_scan(*t)
    assert torch.equal(y, py) and torch.equal(h, ph)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.mamba1_scan_gated(*t)  # the kernel takes no CPU tensor
    with pytest.raises(ValueError, match="unsupported device"):
        ops.gated_selective_scan(*[None if a is None else a.to("meta")
                                   for a in t])


def test_gated_input_rules():
    t = _gated_torch(_gated_inputs(14, 2, 5, 8, 4, h0=True))
    scan = ops.gated_selective_scan

    def swap(i, v):
        u = list(t)
        u[i] = v
        return u

    with pytest.raises(ValueError, match=r"dt_raw, x and z must be one"):
        scan(*swap(7, t[7][:, :4]))  # z of the wrong shape
    with pytest.raises(ValueError, match=r"dt_raw, x and z must be one"):
        scan(*swap(0, t[0][..., :7]))
    with pytest.raises(ValueError, match="share one dtype"):
        scan(*swap(0, t[0].double()))  # dt_raw of the wrong dtype
    with pytest.raises(ValueError, match="share one dtype"):
        scan(*swap(0, t[0].bfloat16()))  # dt_raw not in x's dtype
    with pytest.raises(ValueError, match="share one dtype"):
        scan(*swap(7, t[7].half()))
    with pytest.raises(ValueError, match=r"A_log must be \(di, N\)"):
        scan(*swap(5, t[5][:, :2]))  # A_log not (di, N)
    with pytest.raises(ValueError, match=r"A_log must be \(di, N\)"):
        scan(*swap(5, t[5].T))
    with pytest.raises(ValueError, match=r"dt_bias \(di,\)"):
        scan(*swap(1, t[1][:3]))
    with pytest.raises(ValueError, match=r"\(B, S, N\)"):
        scan(*swap(3, t[3][:, :4]))
    with pytest.raises(ValueError, match=r"h0 must be"):
        scan(*swap(8, t[8][:1]))
    with pytest.raises(ValueError, match="must be float32"):
        scan(*swap(5, t[5].double()))


@pytest.mark.parametrize("rows,steps,N,G", [
    (4 * 8192, 4096, 16, 1), (8192, 32768, 16, 4), (4 * 8192, 1, 16, 2),
    (8192, 1, 16, 4), (2 * 64, 16, 2, 2), (2 * 64, 16, 8, 4)])
def test_threads_per_channel(rows, steps, N, G):
    """G for falcon-mamba's prefill shapes (1 and 4), its decode step (2),
    and small grids (the most lanes, at most N)."""
    assert tk.threads_per_channel(rows, steps, 132, N) == G
