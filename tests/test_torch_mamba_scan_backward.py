"""The gated scan's backward in the port (B7's gradient) against autograd
and against the JAX reference, on the CPU.

``ops.plain_gated_scan_backward`` is the backward kernel's plain version:
the explicit adjoint recurrence, a reverse loop over time in the kernel's
fp32 op order (``csrc/mamba_scan_bwd.cu``). It is held, on the same numpy
inputs,
  * against ``ops.gated_scan_backward_plain`` (autograd of
    ``plain_gated_scan``, the port's CPU gradient): fp32 within 1e-6
    max|g| of each leaf, bf16 within one bf16 ulp of max|g|;
  * against ``jax.vjp`` of the reference's composition (fp32 softplus of
    dt_raw + dt_bias, A = -exp(A_log), ``repro.kernels.mamba_scan.ref.
    mamba1_scan_ref``, the silu(z) gate; ``repro/models/ssm.py``
    ``_mamba1_inner``) in fp32 within 3e-5 max|g|, the repo's gradient
    bar;
at smoke sizes, with dt_raw + dt_bias above softplus's threshold (20)
every 7th value, h0 given or not, dy with and without dhT. The kernel
itself runs only on a card: ``tests/test_torch_mamba_scan_backward_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba1_scan_ref as j_ref
from repro_torch.kernels.mamba_scan import mamba_scan as tk
from repro_torch.kernels.mamba_scan import ops

B, S, DI, N = 2, 37, 24, 8  # S not a multiple of the kernel's chunk
REF_BAR = 3e-5  # the repo's gradient bar against the reference


def _inputs(seed, h0):
    """The gated scan's inputs, dy and dhT as numpy float32: dt_raw 3
    normal with every 7th value above softplus's threshold, dt_bias
    normal - 3, x, B, C, z, D normal, A_log 0.5 normal, h0 (or None)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt_raw = 3 * f(B, S, DI)
    dt_raw.reshape(-1)[::7] = 24 + np.abs(dt_raw.reshape(-1)[::7])
    args = [dt_raw, f(DI) - 3, f(B, S, DI), f(B, S, N), f(B, S, N),
            0.5 * f(DI, N), f(DI), f(B, S, DI), f(B, DI, N) if h0 else None]
    return args, f(B, S, DI), f(B, DI, N)


def _torch(args, dy, dhT, dtype):
    """The port's tensors: dt_raw, x, B, C, z and dy in ``dtype``, the
    rest fp32; dhT None when not given."""
    out = [None if a is None else torch.from_numpy(a) for a in args]
    for i in (0, 2, 3, 4, 7):
        out[i] = out[i].to(dtype)
    return (out, torch.from_numpy(dy).to(dtype),
            None if dhT is None else torch.from_numpy(dhT))


def _ulp_bar(want, dtype):
    top = float(want.float().abs().max())
    if dtype == torch.float32:
        return 1e-6 * top
    return torch.finfo(dtype).eps * 2.0 ** np.floor(np.log2(top))


@pytest.mark.parametrize("with_dhT", [True, False])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_autograd(dtype, h0, with_dhT):
    args, dy, dhT = _inputs(3, h0)
    t, dyt, dht = _torch(args, dy, dhT if with_dhT else None, dtype)
    got = ops.plain_gated_scan_backward(*t, dyt, dht)
    want = ops.gated_scan_backward_plain(*t, dyt, dht)
    for name, g, w, a in zip(tk.GATED_INPUTS, got, want, t):
        if a is None:
            assert g is None and w is None, name
            continue
        # dB_in and dC_in stay fp32; the Function rounds them to B_in's
        # dtype, as here
        sums_kept = name in ("B_in", "C_in")
        assert g.shape == a.shape and g.dtype == (
            torch.float32 if sums_kept else a.dtype), name
        g = g.to(a.dtype)
        err = float((g.float() - w.float()).abs().max())
        bar = _ulp_bar(w, a.dtype)
        assert err <= bar, f"{name}: {err:.3e} > {bar:.3e}"


def _jax_vjp(args, dy, dhT):
    """jax.vjp of the reference's composition around its scan oracle."""
    f32 = jnp.float32
    has_h0 = args[8] is not None

    def f(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, *h0):
        dt = jax.nn.softplus(dt_raw.astype(f32) + dt_bias)
        y, h = j_ref(dt, x, B_in, C_in, -jnp.exp(A_log), D,
                     h0[0] if h0 else None)
        return (y * jax.nn.silu(z.astype(f32))).astype(x.dtype), h

    primals = [jnp.asarray(a) for a in args if a is not None]
    _, vjp = jax.vjp(f, *primals)
    ct_h = (jnp.zeros((B, DI, N), f32) if dhT is None
            else jnp.asarray(dhT))
    grads = list(vjp((jnp.asarray(dy), ct_h)))
    return grads + ([] if has_h0 else [None])


@pytest.mark.parametrize("with_dhT", [True, False])
@pytest.mark.parametrize("h0", [False, True])
def test_plain_backward_matches_reference_vjp(h0, with_dhT):
    args, dy, dhT = _inputs(5, h0)
    dhT = dhT if with_dhT else None
    t, dyt, dht = _torch(args, dy, dhT, torch.float32)
    got = ops.plain_gated_scan_backward(*t, dyt, dht)
    want = _jax_vjp(args, dy, dhT)
    for name, g, w in zip(tk.GATED_INPUTS, got, want):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        top = float(np.abs(w).max())
        assert top > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REF_BAR * top, err_msg=name)


def test_threshold_branch_passes_the_gradient_through():
    """Where v = dt_raw + dt_bias > 20, softplus is the identity and
    ddt_raw is ddt itself (torch's softplus gradient); below it, ddt
    sigma(v). Both branches against autograd, each on its own elements
    (the reference's softplus has no threshold; its sigma(v) is within
    exp(-20) of 1 there, which the vjp test above holds)."""
    args, dy, dhT = _inputs(11, False)
    t, dyt, dht = _torch(args, dy, dhT, torch.float32)
    v = t[0] + t[1]
    over = v > 20
    assert 0 < int(over.sum()) < v.numel()
    got = ops.plain_gated_scan_backward(*t, dyt, dht)[0]
    want = ops.gated_scan_backward_plain(*t, dyt, dht)[0]
    bar = 1e-6 * float(want.abs().max())
    assert float((got - want)[over].abs().max()) <= bar
    assert float((got - want)[~over].abs().max()) <= bar
    assert bool(torch.isfinite(got).all()) and bool((got[over] != 0).any())


@pytest.mark.parametrize("needs", [
    (True,) * 9,
    (False, True, False, True, False, True, False, True, False),
    (True, False, True, False, True, False, True, False, True),
    (False,) * 8 + (True,),
])
@pytest.mark.parametrize("h0", [False, True])
def test_none_pattern_follows_needs(needs, h0):
    args, dy, dhT = _inputs(13, h0)
    t, dyt, dht = _torch(args, dy, dhT, torch.bfloat16)
    got = ops.plain_gated_scan_backward(*t, dyt, dht, needs=needs)
    full = ops.plain_gated_scan_backward(*t, dyt, dht)
    for name, g, f, need, a in zip(tk.GATED_INPUTS, got, full, needs, t):
        if need and a is not None:
            assert g is not None and torch.equal(g, f), name
        else:
            assert g is None, name
    none = ops.plain_gated_scan_backward(*t, None, None)
    assert none == (None,) * 9


def test_fp32_sums_and_magnitudes():
    """dB_in and dC_in, the sums over channels, stay fp32 on bf16 inputs
    (every other gradient is in its input's dtype); each reduction is
    within its terms' magnitudes."""
    args, dy, dhT = _inputs(17, True)
    t, dyt, dht = _torch(args, dy, dhT, torch.bfloat16)
    kept = ops.plain_gated_scan_backward(*t, dyt, dht)
    for i, (g, a) in enumerate(zip(kept, t)):
        assert g.dtype == (torch.float32 if i in (3, 4) else a.dtype), i
    assert t[3].dtype == torch.bfloat16
    mags = ops.gated_scan_backward_magnitudes(*t, dyt, dht)
    assert sorted(mags) == ["A_log", "B_in", "C_in", "D", "dt_bias"]
    for name, m in mags.items():
        g = kept[tk.GATED_INPUTS.index(name)].float()
        assert m.shape == g.shape and bool((g.abs() <= m * (1 + 1e-5)).all())


def test_the_kernels_wrapper_refuses_cpu_tensors():
    """No fallback: the backward kernel's wrapper takes CUDA tensors only,
    and rejects a dy of another dtype before any launch."""
    args, dy, dhT = _inputs(19, False)
    t, dyt, dht = _torch(args, dy, dhT, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.mamba1_scan_gated_backward(*t, dyt, dht)
    with pytest.raises(ValueError, match="dy must be"):
        ops.plain_gated_scan_backward(*t, dyt.to(torch.bfloat16), dht)
