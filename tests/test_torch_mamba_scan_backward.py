"""The gated scan's backward in the port (B7's gradient) against autograd
and against the JAX reference, on the CPU.

``ops.plain_gated_scan_backward`` is the backward kernel's plain version:
the explicit adjoint recurrence, a reverse loop over time in the kernel's
fp32 op order (``csrc/mamba_scan_bwd.cu``). It is held, on the same numpy
inputs,
  * against ``ops.autograd_gated_scan_backward`` (autograd of
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
    want = ops.autograd_gated_scan_backward(*t, dyt, dht)
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
    want = ops.autograd_gated_scan_backward(*t, dyt, dht)[0]
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


def _lane_split_fold(p: torch.Tensor, G: int) -> list[torch.Tensor]:
    """The backward kernel's sum over the N states of a channel, emulated
    in torch: lane g of the channel's G holds states g, g + G, ...
    (``p[..., g + G k]``), folds its own M = N / G values in halves
    (k + M/2 onto k, ...), then the lanes add across xor offsets G/2, ...,
    1. Returns every lane's sum."""
    N = p.shape[-1]
    lanes = [p[..., g::G].clone() for g in range(G)]
    for g in range(G):
        q = lanes[g]
        while q.shape[-1] > 1:
            w = q.shape[-1] // 2
            q = q[..., :w] + q[..., w:]
        lanes[g] = q[..., 0]
    off = G // 2
    while off:
        lanes = [lanes[g] + lanes[g ^ off] for g in range(G)]
        off //= 2
    assert N % G == 0
    return lanes


@pytest.mark.parametrize("G", tk.GROUPS)
@pytest.mark.parametrize("N", tk.STATE_SIZES)
def test_lane_split_fold_is_fold_sum(N, G):
    """The kernel's lane-split fold gives ``ref._fold_sum`` 's bits at
    every (N, G), on every lane: per-element gradients that go through a
    sum over n (u, dx, ddt_raw) do not depend on G."""
    from repro_torch.kernels.mamba_scan.ref import _fold_sum

    rng = np.random.default_rng(N * 10 + G)
    # magnitudes over 12 decades, so the order of the adds shows in the
    # bits
    p = torch.from_numpy((rng.normal(size=(4096, N))
                          * 10.0 ** rng.integers(-6, 6, size=(4096, N))
                          ).astype(np.float32))
    want = _fold_sum(p)
    for lane in _lane_split_fold(p, G):
        assert torch.equal(lane, want)
    # the order matters at these magnitudes: a sequential sum differs
    seq = p[..., 0].clone()
    for n in range(1, N):
        seq = seq + p[..., n]
    assert not torch.equal(seq, want)


def _chunk_channel_sum(terms: torch.Tensor, G: int, nvalid: int):
    """The backward kernel's sum of a (128 channels, N) row of dB or dC
    terms over the block's channels, emulated: the row as the kernel
    keeps it (thread t = channel * G + lane, its M states in vectors of
    up to 4), lane l of a warp adding the vectors l + 32 m in four
    interleaved runs (m % 4), the runs added in pairs, then the lanes
    that hold the same states added across xor offsets G, ..., 16."""
    C, N = terms.shape
    M = N // G
    V = min(M, 4)
    threads = C * G
    # kept[k4][t][e] = state (t % G) + G (4 k4 + e) of channel t // G
    kept = torch.empty((M // V, threads, V))
    for t in range(threads):
        ch, g = divmod(t, G)
        for k in range(M):
            kept[k // V, t, k % V] = terms[ch, g + G * k]
    res = torch.empty((32, M))
    for lane in range(32):
        for k4 in range(M // V):
            runs = torch.zeros((4, V))
            for m in range(threads // 32):
                tq = lane + 32 * m
                if tq // G < nvalid:
                    runs[m % 4] = runs[m % 4] + kept[k4, tq]
            res[lane, k4 * V:(k4 + 1) * V] = ((runs[0] + runs[1])
                                              + (runs[2] + runs[3]))
    off = G
    while off < 32:
        res = res + res[torch.arange(32) ^ off]
        off *= 2
    out = torch.empty(N)
    for g in range(G):
        out[g::G] = res[g]
    return out


@pytest.mark.parametrize("G", tk.GROUPS)
@pytest.mark.parametrize("N,nvalid", [(4, 128), (16, 128), (16, 37),
                                      (32, 1)])
def test_chunk_channel_sum_within_bar(N, G, nvalid):
    """The kernel's fixed order for a step's sums over a block's channels
    (emulated) is within the card tests' bar, 1e-6 sum|terms| + 1e-7, of
    the float64 sum of the valid channels' terms, and leaves the
    channels past di out."""
    rng = np.random.default_rng(N + G + nvalid)
    terms = torch.from_numpy(rng.normal(size=(128, N)).astype(np.float32)
                             * 10.0 ** rng.integers(-3, 3, size=(128, N)))
    terms[nvalid:] = float("nan")  # a ragged block's lanes past di
    got = _chunk_channel_sum(terms, G, nvalid).double()
    valid = terms[:nvalid].double()
    bar = 1e-6 * valid.abs().sum(0) + 1e-7
    assert bool(((got - valid.sum(0)).abs() <= bar).all())


@pytest.mark.parametrize("N", tk.STATE_SIZES)
def test_backward_group_is_the_most_lanes(N):
    """The backward kernel's G: the most lanes a channel up to N (one
    block of 128 channels fits an SM at every G, so more lanes are more
    resident warps whatever the grid); a pure function of N."""
    G = tk.backward_group(N)
    assert G == max(g for g in tk.GROUPS if g <= N) == 4
    assert N % G == 0 and tk.backward_chunk(N) % G == 0


@pytest.mark.parametrize("group", [0, *tk.GROUPS])
def test_backward_operator_shapes_do_not_depend_on_group(group):
    """Under FakeTensorMode the backward operator gives the same outputs
    at every G: the partials of dB and dC per block of 128 channels (3
    blocks at di = 300) and the workspace of ceil(S / chunk) states."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    Bb, S, di, N = 2, 37, 300, 16
    f32 = torch.float32
    with FakeTensorMode():
        def e(*shape, dt=torch.bfloat16):
            return torch.empty(shape, dtype=dt, device="cuda")

        args = [e(Bb, S, di), e(di, dt=f32), e(Bb, S, di), e(Bb, S, N),
                e(Bb, S, N), e(di, N, dt=f32), e(di, dt=f32), e(Bb, S, di),
                None]
        mask = tk.needs_mask(None, None)
        outs = tk._GATED_BWD(*args, e(Bb, S, di), None, mask, group)
        got = [(tuple(t.shape), t.dtype) for t in outs]
    assert got == [(tuple(shape), dt) for shape, dt in tk._backward_shapes(
        (Bb, S, di), torch.bfloat16, N, mask)]
    assert got[4][0] == (Bb, S, 3, 2 * N)
    assert got[8][0] == (Bb, -(-S // tk.backward_chunk(N)), di, N)
