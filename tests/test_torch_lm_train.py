"""The port's LM training path (``repro_torch.models`` loss and train
step, ``repro_torch.optim.AdamW``, the backward of B6 and B7's plain
versions, ``core/head.py``) against the JAX reference on the same numpy
weights and batches, on the CPU.

Both packages get the reference's ``init_model`` parameters, through
``convert.model_from_reference(..., trainable=True)``, and the same numpy
token batches, at reduced configs in fp32 unless a test says otherwise.
Bars:
  * ``cross_entropy`` rtol 1e-6; ``chunked_cross_entropy`` against the
    port's full CE at ``tests/test_chunked_ce.py``'s bars (loss rtol
    1e-4, bf16 gradients rtol 5e-2 / atol 2e-3) and against the
    reference's chunked CE at rtol 1e-5;
  * ``loss_fn`` rtol 1e-5 and every gradient leaf within 1e-4 max|g_ref|
    + 1e-7 (bf16: loss rtol 5e-2, leaves within 5e-2 max|g_ref|);
  * three AdamW steps: losses rtol 1e-4, every parameter within 2 lr n
    of the reference's and within AdamW's own sensitivity to the
    gradient bar, 1e-6 + lr sum_t min(2, e_t / |g_t|) per element (its
    update is scale-free in g, so elements with a gradient near 0 move
    most: granite's experts); within 1e-6 on 99.9% of the elements whose
    gradient keeps that sum under 1e-3; and the loss falls;
  * ``AdamW`` rtol 1e-6 / atol 1e-7; the scan backward bitwise; the
    chunked attention backward within 1e-6 max|g|; the head rtol 1e-6
    (its gradient, whose small elements are cancelling sums, within
    1e-6 max|g|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.core import head as jhead
from repro.core.lsplm import LSPLMParams as JParams
from repro.models import transformer as jtransformer
from repro.optim import AdamW as JAdamW
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.core import head as thead
from repro_torch.core.lsplm import LSPLMParams as TParams
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels.flash_attention import flash_attention as tk_attn
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.lsplm_fused import lsplm_fused as tk_b5
from repro_torch.kernels.mamba_scan import mamba_scan as tk_scan
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamW

B, S = 2, 16
LOSS_ARCHS = ["llama3.2-1b", "olmo-1b", "qwen1.5-32b", "granite-moe-1b-a400m",
              "internvl2-2b", "musicgen-medium", "falcon-mamba-7b",
              "zamba2-2.7b"]
FAMILY_ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "zamba2-2.7b",
                "falcon-mamba-7b", "internvl2-2b", "musicgen-medium"]
TRAIN_ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "zamba2-2.7b"]


def _configs(arch, **over):
    j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **over)
    t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **over)
    return j, t


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jmodels.init_model(
        jcfg, jax.random.PRNGKey(seed)))


def _batch(cfg, seed=1, s=S, weights=False):
    """A numpy batch for cfg: tokens and labels from the token stream, or
    0.1 N(0, 1) embeds (audio), with 0.1 N(0, 1) prefix embeds (vlm) and
    0/1 loss weights on request."""
    rng = np.random.default_rng(seed)
    b = TokenStream(cfg.vocab_size, seed=seed).batch(B, s + 1)
    out = {"labels": b["labels"]}
    if cfg.embeds_in:
        out["embeds"] = (0.1 * rng.normal(size=(B, s, cfg.d_model))
                         ).astype(np.float32)
    else:
        out["tokens"] = b["tokens"]
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = (0.1 * rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    if weights:
        out["loss_weights"] = (rng.random((B, s)) > 0.3).astype(np.float32)
    return out


def _model(params, tcfg):
    return convert.model_from_reference(params, tcfg, device="cpu",
                                        trainable=True)


def _by_name(tree):
    """A reference pytree (params or grads) as {port parameter name:
    numpy array}: layers/<group>/<leaf>[i] -> layers.i.<group>.<leaf>."""
    out = {}

    def walk(prefix, node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(prefix + (key,), value)
            elif prefix[:1] == ("layers",):
                for i, a in enumerate(np.asarray(value)):
                    out[".".join(("layers", str(i)) + prefix[1:]
                                 + (key,))] = a
            else:
                out[".".join(prefix + (key,))] = np.asarray(value)

    walk((), tree)
    return out


def _grads(model, loss):
    """{parameter name: its gradient as numpy} (zeros where the loss does
    not reach, as jax.grad gives)."""
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {n: (np.zeros(p.shape, np.float32) if g is None else
                g.float().numpy()) for (n, p), g in zip(named, grads)}


def _leaf_close(got: dict, want: dict, rel, absolute=1e-7):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        bar = rel * np.abs(w).max() + absolute
        err = np.abs(got[name] - w).max()
        assert err <= bar, (name, err, bar)


_JIT = {}


def _j_value_and_grad(jcfg):
    if jcfg not in _JIT:
        _JIT[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: jtransformer.loss_fn(p, jcfg, b), has_aux=True))
    return _JIT[jcfg]


# ------------------------------------------------------------------- CE
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_reference(weighted):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    w = (rng.random((2, 7)) > 0.4).astype(np.float32) if weighted else None
    want = jtransformer.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                      None if w is None else jnp.asarray(w))
    got = tmodels.cross_entropy(torch.from_numpy(logits), labels, w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_all_weights_zero_divides_by_one():
    logits = torch.zeros(1, 3, 4)
    got = tmodels.cross_entropy(logits, np.zeros((1, 3), np.int32),
                                np.zeros((1, 3), np.float32))
    assert float(got) == 0.0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "internvl2-2b"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_ce_matches_full(arch, chunk):
    """The port's counterpart of tests/test_chunked_ce.py, at its bars
    (bf16, the configs' own dtype)."""
    jcfg, tcfg = _configs(arch)
    params = _params(jcfg)
    batch = _batch(tcfg)
    full = _model(params, tcfg)
    chunked = _model(params, dataclasses.replace(tcfg, ce_chunk=chunk))
    l_full, _ = tmodels.loss_fn(full, batch)
    l_chunk, _ = tmodels.loss_fn(chunked, batch)
    np.testing.assert_allclose(l_full.item(), l_chunk.item(), rtol=1e-4)
    g_full, g_chunk = _grads(full, l_full), _grads(chunked, l_chunk)
    for name in g_full:
        np.testing.assert_allclose(g_full[name], g_chunk[name], rtol=5e-2,
                                   atol=2e-3, err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_chunked_ce_matches_reference_chunked(weighted):
    jcfg, tcfg = _configs("llama3.2-1b", dtype="float32")
    params = _params(jcfg)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    w = (rng.random((B, S)) > 0.3).astype(np.float32) if weighted else None
    want = jtransformer.chunked_cross_entropy(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(h),
        jnp.asarray(labels), None if w is None else jnp.asarray(w), None, 4)
    got = tmodels.chunked_cross_entropy(_model(params, tcfg),
                                        torch.from_numpy(h), labels, w, 4)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_chunked_ce_refuses_a_chunk_that_does_not_divide():
    _, tcfg = _configs("llama3.2-1b", dtype="float32")
    model = tmodels.init_model(tcfg, torch.Generator().manual_seed(0),
                               device="cpu", trainable=True)
    with pytest.raises(ValueError, match="not a multiple"):
        tmodels.chunked_cross_entropy(model, torch.zeros(1, 6, tcfg.d_model),
                                      np.zeros((1, 6), np.int32), None, 4)


# ------------------------------------------------------ loss and gradient
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grad_match_reference(arch):
    jcfg, tcfg = _configs(arch, dtype="float32")
    params = _params(jcfg)
    batch = _batch(tcfg, weights=arch == "olmo-1b")
    (want, (jce, jaux)), jgrads = _j_value_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    model = _model(params, tcfg)
    loss, (ce, aux) = tmodels.loss_fn(model, batch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-7)
    _leaf_close(_grads(model, loss), _by_name(jgrads), 1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmo-1b", "qwen1.5-32b"])
def test_loss_and_grad_match_reference_bf16(arch):
    """The dense flavours in bf16. (granite-moe is held in fp32 only: in
    bf16 its gradient leaves part from the reference's by up to ~0.3
    max|g|, the router's most; see ROADMAP.md C.)"""
    jcfg, tcfg = _configs(arch)
    params = _params(jcfg)
    batch = _batch(tcfg)
    (want, _), jgrads = _j_value_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    model = _model(params, tcfg)
    loss, _ = tmodels.loss_fn(model, batch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=5e-2)
    _leaf_close(_grads(model, loss), _by_name(jgrads), 5e-2)


# -------------------------------------------------------------- the step
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_match_reference(arch):
    lr, steps = 1e-3, 3
    jcfg, tcfg = _configs(arch, dtype="float32")
    params = _params(jcfg)
    batch = _batch(tcfg)
    jopt, jstep = jtransformer.make_train_step(jcfg, lr=lr)
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jbatch = jax.tree.map(jnp.asarray, batch)
    model = _model(params, tcfg)
    opt, step = tmodels.make_train_step(model, lr=lr)
    state = opt.init(dict(model.named_parameters()))
    losses = []
    sens = {}  # per element: sum over steps of AdamW's gradient sensitivity
    for _ in range(steps):
        _, jg = _j_value_and_grad(jcfg)(jp, jbatch)
        for name, g in _by_name(jax.tree.map(np.asarray, jg)).items():
            err = 1e-4 * np.abs(g).max() + 1e-7  # the gradient leaves' bar
            sens[name] = sens.get(name, 0.0) + np.minimum(
                2.0, err / np.maximum(np.abs(g), 1e-30))
        jp, jstate, jm = jstep(jp, jstate, jbatch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]  # tests/test_archs_smoke.py:73
    got = _by_name(convert.params_to_reference(model))
    want = _by_name(jax.tree.map(np.asarray, jp))
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    assert diffs.max() <= 2 * lr * steps
    # AdamW's update lr m^/(sqrt(v^) + eps) is scale-free in g, so a
    # gradient error e moves it by up to ~lr e / |g| (2 lr once e >= |g|):
    # each element within 1e-6 + lr sum_t min(2, e_t / |g_t|), e_t the
    # gradient leaves' own bar at step t; and 99.9% of the elements whose
    # gradient keeps that sum under 1e-3 within 1e-6.
    bars = np.concatenate([(1e-6 + lr * sens[n]).ravel() for n in want])
    sharp = np.concatenate([(sens[n] <= 1e-3).ravel() for n in want])
    assert np.all(diffs <= bars), float(np.max(diffs / bars))
    assert np.mean(diffs[sharp] <= 1e-6) >= 0.999


def test_train_step_needs_a_trainable_model():
    _, tcfg = _configs("llama3.2-1b", dtype="float32")
    model = tmodels.init_model(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        tmodels.make_train_step(model)


@pytest.mark.parametrize("callable_lr", [False, True])
def test_adamw_matches_reference(callable_lr):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    lr = (lambda c: 1e-2 / (1.0 + 0.5 * c)) if callable_lr else 1e-2
    jopt = JAdamW(lr=lr, weight_decay=0.01)
    topt = AdamW(lr=lr, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    up = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ustate = topt.init(up)
    for g in grads:
        jupd, _ = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jstate, jp)
        jp, jstate = jopt.apply({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        upd, ustate = topt.update(tg, ustate, up)
        for k in up:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-7)
            up[k] = up[k] + upd[k]
        same = tp
        tp, tstate = topt.apply(tg, tstate, tp)
        assert tp is same  # in place
    assert tstate.count == 5 and int(jstate.count) == 5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(up[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.nu[k].numpy(),
                                   np.asarray(jstate.nu[k]), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_takes_a_list_and_refuses_mismatched_trees():
    opt = AdamW(lr=0.1)
    params = [torch.ones(3), torch.zeros(2)]
    state = opt.init(iter(params))
    grads = [torch.ones(3), torch.ones(2)]
    opt.apply(grads, state, params)
    assert torch.all(params[0] < 1) and torch.all(params[1] < 0)
    with pytest.raises(ValueError, match="same length"):
        opt.apply(grads[:1], state, params)
    with pytest.raises(ValueError, match="same keys"):
        opt.apply({"a": torch.ones(1)}, opt.init({"b": torch.ones(1)}),
                  {"b": torch.ones(1)})


# --------------------------------------------------- kernels' backwards
@pytest.mark.parametrize("kvh,causal,S_", [(2, True, 40), (4, True, 33),
                                           (2, False, 24)])
def test_attention_backward_plain_matches_autograd(kvh, causal, S_):
    rng = np.random.default_rng(5)
    Bq, H, hd = 2, 4, 16
    q, k, v = (torch.from_numpy(rng.normal(size=(Bq, S_, h, hd)).astype(
        np.float32)) for h in (H, kvh, kvh))
    do = torch.from_numpy(rng.normal(size=(Bq, S_, H, hd)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attn_ops.plain_attention(*leaves, causal=causal, chunk=8)
    want = torch.autograd.grad(o, leaves, do)
    got = attn_ops.attention_backward_plain(q, k, v, do, 8, causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_scan_backward_plain_is_autograd(h0, dtype):
    rng = np.random.default_rng(6)
    Bq, S_, di, N = 2, 9, 12, 4
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    args = [3 * f(Bq, S_, di), f(di) - 3, f(Bq, S_, di), f(Bq, S_, N),
            f(Bq, S_, N), 0.5 * f(di, N), f(di), f(Bq, S_, di),
            f(Bq, di, N) if h0 else None]
    for i in (0, 2, 3, 4, 7):
        args[i] = args[i].to(dtype)
    dy, dh = f(Bq, S_, di).to(dtype), f(Bq, di, N)
    leaves = [None if a is None else a.clone().requires_grad_()
              for a in args]
    y, hT = scan_ops.plain_gated_scan(*leaves)
    wrt = [t for t in leaves if t is not None]
    want = torch.autograd.grad([y, hT], wrt, [dy, dh])
    got = [g for g in scan_ops.autograd_gated_scan_backward(*args, dy, dh)
           if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # only y's gradient: hT's contribution left out, as autograd leaves it
    y, _ = scan_ops.plain_gated_scan(*leaves)
    want = torch.autograd.grad(y, wrt, dy)
    got = [g for g in scan_ops.autograd_gated_scan_backward(*args, dy, None)
           if g is not None]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_wrappers_refuse_a_graph_they_would_cut():
    """B5, B6 and B7's ctypes wrappers have no backward: under grad mode an
    input that requires a gradient raises, before the device check (so
    here, on the CPU); under no_grad the CPU tensor meets the device
    check instead."""
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="ops.causal_attention"):
        tk_attn.flash_attention(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        tk_attn.flash_attention(q, k, k)
    x = torch.zeros(1, 3, 4)
    s_args = [x, torch.zeros(4, requires_grad=True), x, torch.zeros(1, 3, 4),
              torch.zeros(1, 3, 4), torch.zeros(4, 4), torch.zeros(4), x]
    with pytest.raises(RuntimeError, match="ops.gated_selective_scan"):
        tk_scan.mamba1_scan_gated(*s_args)
    with pytest.raises(RuntimeError, match="ops.plain_scan"):
        tk_scan.mamba1_scan(x, x.clone().requires_grad_(), *s_args[3:5],
                            torch.zeros(4, 4), torch.zeros(4))
    u = torch.zeros(5, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="predict_logits_stable"):
        tk_b5.lsplm_fused_forward(torch.zeros(2, 5), u, u)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        tk_b5.lsplm_fused_forward(torch.zeros(2, 5), u, u)


# ------------------------------------------------------------------ head
def test_head_matches_reference():
    rng = np.random.default_rng(7)
    d, m, n = 24, 5, 40
    u, w = (0.3 * rng.normal(size=(d, m))).astype(np.float32), (
        0.3 * rng.normal(size=(d, m))).astype(np.float32)
    h = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    jp = JParams(u=jnp.asarray(u), w=jnp.asarray(w))
    tp = TParams(u=torch.from_numpy(u).requires_grad_(),
                 w=torch.from_numpy(w).requires_grad_())
    np.testing.assert_allclose(
        thead.head_proba(tp, torch.from_numpy(h)).detach().numpy(),
        np.asarray(jhead.head_proba(jp, jnp.asarray(h))), rtol=1e-6)
    want, (gu, gw) = jax.value_and_grad(
        lambda p: jhead.head_nll(p, jnp.asarray(h), jnp.asarray(y)))(jp)
    got = thead.head_nll(tp, torch.from_numpy(h), y)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # the gradient's small elements are sums that cancel: 1e-6 of max|g|
    du, dw = torch.autograd.grad(got, [tp.u, tp.w])
    _leaf_close({"u": du.numpy(), "w": dw.numpy()},
                {"u": np.asarray(gu), "w": np.asarray(gw)}, 1e-6, 0.0)


def test_init_head_shapes_and_scale():
    p = thead.init_head(torch.Generator().manual_seed(0), 64, num_regions=6)
    assert p.u.shape == p.w.shape == (64, 6)
    assert p.u.dtype == torch.float32 and not torch.equal(p.u, p.w)
    assert 0.01 < float(p.u.std()) < 0.03


# ---------------------------------------------------- parameters, remat
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_params_to_reference_round_trip_is_bitwise(arch):
    jcfg, tcfg = _configs(arch)
    params = _params(jcfg)
    model = _model(params, tcfg)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    back = convert.params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serving_model_stays_bf16_without_grad():
    jcfg, tcfg = _configs("granite-moe-1b-a400m")
    model = convert.model_from_reference(_params(jcfg), tcfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert model.layers[0].ffn.w1.dtype == torch.bfloat16
    assert model.layers[0].norm1.dtype == torch.float32


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b", "falcon-mamba-7b"])
def test_remat_is_the_same_loss_and_gradient(arch, monkeypatch):
    """remat=True checkpoints each block (the hybrid: each group): the
    same loss bit for bit, the gradients up to rounding, and the MoE's
    recompute keeps the forward's assignments (the backward recomputes
    the layers last first)."""
    jcfg, tcfg = _configs(arch, dtype="float32")
    model = _model(_params(jcfg), tcfg)
    batch = _batch(tcfg)
    keeps = []
    plan = tmoe.dispatch_plan

    def recording(*a, **kw):
        out = plan(*a, **kw)
        keeps.append(out.keep.clone())
        return out

    monkeypatch.setattr(tmoe, "dispatch_plan", recording)
    runs = {}
    for remat in (False, True):
        keeps.clear()
        logits, aux = tmodels.forward(model, tokens=batch["tokens"],
                                      remat=remat)
        loss = (tmodels.cross_entropy(logits, batch["labels"])
                + tcfg.router_aux_coef * aux)
        runs[remat] = (loss, _grads(model, loss), list(keeps))
    (l0, g0, k0), (l1, g1, k1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for name in g0:
        assert np.abs(g0[name] - g1[name]).max() <= 1e-6 * np.abs(
            g0[name]).max(), name
    if tcfg.num_experts:
        L = tcfg.num_layers
        assert len(k0) == L and len(k1) == 2 * L  # forward + recompute
        for a, b, c in zip(k0, k1[:L], k1[L:][::-1]):
            assert torch.equal(a, b) and torch.equal(b, c)
