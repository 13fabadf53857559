"""The port's Mamba1 family (``repro_torch.models.ssm`` and the ssm
branches of ``models.transformer``) against the JAX reference
(``repro.models.ssm``, ``repro.models``) on the same weights and inputs,
on the CPU.

Layer bars: ``mamba1_forward`` and its state within 3e-5 in fp32
(``tests/test_kernels.py:228``); forward against step-by-step decode
within rtol 1e-4 / atol 1e-5 and the prefill-to-decode handoff within
2e-4 / 2e-5 (``tests/test_ssm.py:27``, ``:72``). Model bars (reduced
``falcon-mamba-7b``, weights carried by ``convert.model_from_reference``):
logits within 1e-4 in fp32 and 5e-2 in bf16
(``tests/test_archs_smoke.py:137``); greedy tokens equal in fp32. The
scan is B7's plain version on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import ssm as JS
from repro.models.generate import generate as jgenerate
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_scan import mamba_scan as tk
from repro_torch.models import ssm as S
from repro_torch.models.generate import generate

_TOY = dict(name="toy-m1", family="ssm", source="t", num_layers=2,
            d_model=32, num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=64,
            ssm_version=1, ssm_state=8, ssm_expand=2, ssm_conv=4)
# tests/test_ssm.py's toy config; the port's layer holds its weights in
# cfg.dtype, so its side is fp32 (the reference's layer runs in x's dtype)
JCFG1, CFG1 = JArchConfig(**_TOY), ArchConfig(**_TOY, dtype="float32")
ARCH = "falcon-mamba-7b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, SEQ = 2, 12


def _layer(cfg=CFG1, jcfg=JCFG1, seed=0):
    """The reference's init_mamba1 leaves (fp32) and the port's Mamba1
    holding them."""
    params = jax.tree.map(np.asarray, JS.init_mamba1(
        jax.random.PRNGKey(seed), jcfg, jnp.float32))
    mod = S.Mamba1(cfg, device="cpu")
    for name, p in mod.named_parameters():
        p.copy_(torch.from_numpy(np.array(params[name])))
    return params, mod


def _x(seed, shape):
    return (0.5 * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _close(got, want, rtol, atol=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol if atol is None else atol)


# ---------------------------------------------------------------- layer
def test_mamba1_forward_and_state_match_reference():
    params, mod = _layer()
    x = _x(1, (B, SEQ, CFG1.d_model))
    want, wst = JS.mamba1_forward(jnp.asarray(x), params, JCFG1,
                                  return_state=True)
    got, st = S.mamba1_forward(torch.from_numpy(x), mod, CFG1,
                               return_state=True)
    _close(got, want, 3e-5)
    assert st.keys() == wst.keys()
    assert st["conv"].shape == (B, CFG1.ssm_conv - 1, CFG1.d_inner)
    assert st["ssm"].shape == (B, CFG1.d_inner, CFG1.ssm_state)
    assert st["ssm"].dtype == torch.float32
    for k in st:
        _close(st[k], wst[k], 3e-5)
    assert torch.equal(S.mamba1_forward(torch.from_numpy(x), mod, CFG1), got)


def test_mamba1_decode_matches_reference():
    params, mod = _layer()
    rng = np.random.default_rng(2)
    x_t = _x(3, (B, CFG1.d_model))
    conv = rng.normal(size=(B, CFG1.ssm_conv - 1, CFG1.d_inner)).astype(
        np.float32)
    ssm = rng.normal(size=(B, CFG1.d_inner, CFG1.ssm_state)).astype(
        np.float32)
    want, wst = JS.mamba1_decode(jnp.asarray(x_t), {
        "conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}, params, JCFG1)
    got, st = S.mamba1_decode(torch.from_numpy(x_t), {
        "conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)}, mod,
        CFG1)
    _close(got, want, 3e-5)
    for k in st:
        _close(st[k], wst[k], 3e-5)


def test_forward_matches_stepwise_decode():
    _, mod = _layer()
    x = torch.from_numpy(_x(1, (B, SEQ, CFG1.d_model)))
    y_full = S.mamba1_forward(x, mod, CFG1)
    y_step = S.mamba_ref_sequential(x, mod, CFG1)
    torch.testing.assert_close(y_step, y_full, rtol=1e-4, atol=1e-5)


def test_state_handoff_prefill_to_decode():
    """forward(x[:8]) state + decode(x[8]) == forward(x[:9])[8]."""
    _, mod = _layer()
    x = torch.from_numpy(_x(1, (B, 9, CFG1.d_model)))
    y_full = S.mamba1_forward(x, mod, CFG1)
    _, st = S.mamba1_forward(x[:, :8], mod, CFG1, return_state=True)
    y_dec, _ = S.mamba1_decode(x[:, 8], st, mod, CFG1)
    torch.testing.assert_close(y_dec, y_full[:, 8], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seq", [1, 2])
def test_short_sequence_conv_state_padding(seq):
    """S < K - 1: the conv state is zero-padded in front, as the
    reference's."""
    params, mod = _layer()
    x = _x(4, (B, seq, CFG1.d_model))
    _, wst = JS.mamba1_forward(jnp.asarray(x), params, JCFG1,
                               return_state=True)
    y, st = S.mamba1_forward(torch.from_numpy(x), mod, CFG1,
                             return_state=True)
    K = CFG1.ssm_conv
    assert st["conv"].shape == (B, K - 1, CFG1.d_inner)
    assert torch.equal(st["conv"][:, :K - 1 - seq],
                       torch.zeros_like(st["conv"][:, :K - 1 - seq]))
    x_in = torch.from_numpy(x) @ mod.in_proj[:, :CFG1.d_inner]
    torch.testing.assert_close(st["conv"][:, K - 1 - seq:], x_in)
    for k in st:
        _close(st[k], wst[k], 3e-5)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """K shifted products added in x's dtype, as the reference's (bf16:
    within one bf16 ulp of the reference's rounding at |y| ~ 1)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JS.causal_conv1d(jnp.asarray(x, jdt), jnp.asarray(w),
                            jnp.asarray(b))
    got = S.causal_conv1d(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                          torch.from_numpy(b))
    assert got.dtype == tdt
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2)


def test_conv_step_is_the_forward_conv_at_the_last_position():
    """The decode conv does causal_conv1d's arithmetic (bf16 products
    added left to right), so its output is the forward's last position
    bit for bit; the reference's einsum (fp32 sums) is within a bf16
    ulp of it."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 7, 40)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    x16 = x.bfloat16()
    full = S.causal_conv1d(x16, w, b)
    state, out = S.conv_step(x16[:, -4:-1], x16[:, -1], w, b)
    assert torch.equal(out, full[:, -1])
    assert torch.equal(state, x16[:, -3:])
    _, want = JS.conv_step(jnp.asarray(np.asarray(x16[:, -4:-1].float()),
                                       jnp.bfloat16),
                           jnp.asarray(np.asarray(x16[:, -1].float()),
                                       jnp.bfloat16),
                           jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
    _close(out, want, 1e-2)


def test_bf16_decode_after_prefill_equals_forward():
    """In bf16 (the serving dtype), decode of token S after prefill of S
    tokens gives the forward's logits at S."""
    model = _pair("bfloat16").model
    toks = torch.from_numpy(_tokens(model.cfg, 6))
    full, _ = tmodels.forward(model, tokens=toks[:, :SEQ + 1])
    _, c0 = tmodels.prefill(model, tokens=toks[:, :SEQ])
    logits, _ = tmodels.decode_step(model, c0, token=toks[:, SEQ], pos=SEQ)
    torch.testing.assert_close(logits.float(), full[:, SEQ].float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def test_parameter_dtypes_follow_the_reference():
    """Matmul weights in the activation dtype; A_log, dt_bias, D and the
    norm scale in param_dtype (fp32), as the reference uses them."""
    cfg = tconfigs.get_config(ARCH).reduced()
    blk = tmodels.MambaBlock(cfg, device="cpu")
    m = blk.mamba
    for w in (m.in_proj, m.conv_w, m.conv_b, m.x_proj, m.dt_proj,
              m.out_proj):
        assert w.dtype == torch.bfloat16
    for w in (m.dt_bias, m.A_log, m.D, blk.norm):
        assert w.dtype == torch.float32


# ---------------------------------------------------------------- model
def _configs(**over):
    j = dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **over)
    t = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **over)
    return j, t


class Pair:
    """Reduced falcon-mamba in both packages on the same weights."""

    def __init__(self, dtype):
        self.jcfg, self.tcfg = _configs(dtype=dtype)
        self.params = jmodels.init_model(self.jcfg, jax.random.PRNGKey(0))
        self.model = convert.model_from_reference(
            jax.tree.map(np.asarray, self.params), self.tcfg, device="cpu")
        cfg = self.jcfg
        self.forward = jax.jit(lambda p, t: jmodels.forward(
            p, cfg, tokens=t, remat=False)[0])
        self.prefill = jax.jit(lambda p, t: jmodels.prefill(p, cfg,
                                                            tokens=t))
        self.decode = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
            p, cfg, c, token=t, pos=pos))


_PAIRS = {}


def _pair(dtype):
    if dtype not in _PAIRS:
        _PAIRS[dtype] = Pair(dtype)
    return _PAIRS[dtype]


def _tokens(cfg, seed, shape=(B, SEQ + 4)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    pair = _pair(dtype)
    toks = _tokens(pair.tcfg, 1)
    want = pair.forward(pair.params, jnp.asarray(toks))
    got, aux = tmodels.forward(pair.model, tokens=torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0
    assert got.shape == (B, SEQ + 4, pair.tcfg.vocab_size)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill(S tokens), the conv and ssm states it returns, then 4
    decode steps from them (the caches updated in place)."""
    pair = _pair(dtype)
    toks = _tokens(pair.tcfg, 2)
    jl, jc = pair.prefill(pair.params, jnp.asarray(toks[:, :SEQ]))
    tl, tc = tmodels.prefill(pair.model, tokens=torch.from_numpy(
        toks[:, :SEQ]))
    _close(tl, jl, TOL[dtype])
    assert tc.keys() == jc.keys() == {"conv", "ssm"}
    assert tc["ssm"].dtype == torch.float32
    assert tc["conv"].dtype == getattr(torch, dtype)
    for name in tc:
        assert tc[name].shape == jc[name].shape
        _close(tc[name], jc[name], TOL[dtype])
    caches = tmodels.init_caches(pair.tcfg, B, SEQ + 4,
                                 dtype=getattr(torch, dtype), device="cpu")
    for name in caches:
        assert caches[name].shape == tc[name].shape
        caches[name].copy_(tc[name])
    conv = caches["conv"]
    for t in range(SEQ, SEQ + 4):
        jl, jc = pair.decode(pair.params, jc, jnp.asarray(toks[:, t]),
                             jnp.asarray(t))
        tl, caches = tmodels.decode_step(pair.model, caches,
                                         token=torch.from_numpy(toks[:, t]),
                                         pos=t)
        assert tl.shape == (B, pair.tcfg.vocab_size)
        _close(tl, jl, TOL[dtype])
    assert caches["conv"] is conv  # updated in place
    for name in caches:
        _close(caches[name], jc[name], TOL[dtype])


def test_prefill_then_decode_equals_forward():
    """Inside the port (fp32): decode after prefill of S tokens gives
    forward's logits at position S."""
    model = _pair("float32").model
    toks = torch.from_numpy(_tokens(model.cfg, 3))
    full, _ = tmodels.forward(model, tokens=toks[:, :SEQ + 1])
    _, c0 = tmodels.prefill(model, tokens=toks[:, :SEQ])
    step = tmodels.make_serve_step(model)
    logits, _ = step(c0, toks[:, SEQ], SEQ)
    torch.testing.assert_close(logits, full[:, SEQ], rtol=1e-4, atol=1e-4)


def test_greedy_generate_matches_reference():
    pair = _pair("float32")
    prompt = _tokens(pair.tcfg, 4, (B, 8))
    want = jgenerate(pair.params, pair.jcfg, jnp.asarray(prompt), 6,
                     jax.random.PRNGKey(2), temperature=0.0)
    got = generate(pair.model, torch.from_numpy(prompt), 6, temperature=0.0)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_model_takes_the_plain_scan():
    model = _pair("bfloat16").model
    before = dict(tk.LAUNCHES)
    out = generate(model, torch.from_numpy(_tokens(model.cfg, 5, (B, 5))), 3,
                   temperature=0.0)
    assert out.shape == (B, 3) and tk.LAUNCHES == before
    assert set(before) == {"mamba1_scan", "mamba1_scan_gated",
                           "mamba1_scan_gated_backward"}


def test_init_model_draws_from_the_generator():
    cfg = tconfigs.get_config(ARCH).reduced()
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv

    def draw(seed):
        return tmodels.init_model(cfg, torch.Generator().manual_seed(seed),
                                  device="cpu")

    a, b = draw(0), draw(0)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.layers[0].mamba.in_proj,
                           draw(1).layers[0].mamba.in_proj)
    ref = jax.tree.map(np.asarray, JS.init_mamba1(
        jax.random.PRNGKey(0), jconfigs.get_config(ARCH).reduced(),
        jnp.float32))
    log_n = np.log(np.arange(1, N + 1, dtype=np.float64)).astype(np.float32)
    for blk in a.layers:
        m = blk.mamba
        # exact: the correctly rounded log(1..N); the reference's XLA log
        # is one ulp above it at 7
        np.testing.assert_array_equal(m.A_log.numpy(),
                                      np.broadcast_to(log_n, (di, N)))
        np.testing.assert_allclose(m.A_log.numpy(), ref["A_log"], rtol=2e-7,
                                   atol=0)
        assert torch.equal(m.D, torch.ones(di))
        assert torch.equal(m.conv_b, torch.zeros(di, dtype=m.conv_b.dtype))
        assert torch.equal(blk.norm, torch.ones(cfg.d_model))
        dt = torch.nn.functional.softplus(m.dt_bias)
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
        assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
        # log-uniform: log dt spreads evenly over [log 1e-3, log 1e-1]
        assert abs(float(torch.log(dt).mean()) - np.log(1e-2)) < 0.3
        for w, scale in ((m.in_proj, cfg.d_model ** -0.5),
                         (m.conv_w, 0.5 / K), (m.x_proj, di ** -0.5),
                         (m.dt_proj, cfg.resolved_dt_rank ** -0.5),
                         (m.out_proj, di ** -0.5)):
            assert abs(float(w.float().std()) - scale) < 0.1 * scale
    assert a.layers[0].mamba.A_log.shape == (di, N)


def test_full_config_parameter_count():
    full = tmodels.Transformer(tconfigs.get_config(ARCH), device="meta")
    assert sum(p.numel() for p in full.parameters()) == 7_272_665_088
    assert isinstance(full.layers[0], tmodels.MambaBlock)


def test_mamba_modules_default_to_the_card():
    cfg = tconfigs.get_config(ARCH).reduced()
    assert S.Mamba1(cfg, device="meta").in_proj.device.type == "meta"
    assert tmodels.MambaBlock(cfg, device="cpu").norm.device.type == "cpu"
    if torch.cuda.is_available():
        assert S.Mamba1(cfg).in_proj.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            S.Mamba1(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.MambaBlock(cfg)


def test_converter_rejects_mismatched_ssm_trees():
    pair = _pair("float32")
    params = jax.tree.map(np.asarray, pair.params)
    mamba = params["layers"]["mamba"]
    bad = {**params, "layers": {**params["layers"], "mamba": {
        **mamba, "A_log": mamba["A_log"][..., :3]}}}
    with pytest.raises(ValueError, match="shape"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")
    missing = {k: v for k, v in mamba.items() if k != "dt_bias"}
    bad = {**params, "layers": {**params["layers"], "mamba": missing}}
    with pytest.raises(ValueError, match="layer leaves"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")
    bad = {**params, "layers": {**params["layers"],
                                "norm1": params["layers"]["norm"]}}
    with pytest.raises(ValueError, match="layer leaves"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")
    bad = {**params, "layers": {**params["layers"],
                                "norm": params["layers"]["norm"][:1]}}
    with pytest.raises(ValueError, match="layers"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")
