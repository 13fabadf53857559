"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE family of
``models.transformer`` against the JAX reference (``repro.models.moe``,
``repro.models``) on the same weights and inputs, on the CPU.

Layer bars (``tests/test_moe.py``'s toy config, fp32): the router's
top-k ids equal and its gates within rtol 1e-6; the dispatch at ample
(capacity factor 8.0) and tight (0.25) capacity against the reference's
``_dispatch_compute``, with the same kept and dropped assignments; at
ample capacity the output against the dense oracle within rtol 2e-4 /
atol 2e-5 and the aux loss within rtol 1e-5 (``tests/test_moe.py:30``,
``:41``); the combine bitwise repeatable. Model bars (reduced
``granite-moe-1b-a400m`` and ``dbrx-132b``, weights carried by
``convert.model_from_reference``): logits within 1e-4 in fp32 and 5e-2
in bf16 (``tests/test_archs_smoke.py:137``); greedy tokens equal in
fp32.
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
from repro.models import moe as JM
from repro.models.generate import generate as jgenerate
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as M
from repro_torch.models.generate import generate

_TOY = dict(name="toy-moe", family="moe", source="test", num_layers=2,
            d_model=32, num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
            num_experts=4, top_k=2)
JCFG, CFG = JArchConfig(**_TOY), ArchConfig(**_TOY, dtype="float32")
ARCHS = ["granite-moe-1b-a400m", "dbrx-132b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, SEQ = 2, 12


def _layer(seed=0):
    """The reference's init_moe leaves (fp32) and the port's MoE holding
    them."""
    params = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(seed),
                                                  JCFG, jnp.float32))
    mod = M.MoE(CFG, device="cpu")
    for name, p in mod.named_parameters():
        p.copy_(torch.from_numpy(np.array(params[name])))
    return params, mod


def _x(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _close(got, want, rtol, atol=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol if atol is None else atol)


def _ref_keep(x, gate, idx, params, capacity):
    """The reference's kept assignments (T, k): its dispatch run with the
    gate of one choice at a time, so a token's output is that choice's
    expert output if kept and zero if dropped."""
    T, k = idx.shape
    keep = np.zeros((T, k), bool)
    for j in range(k):
        one = np.zeros((T, k), np.float32)
        one[:, j] = 1.0
        out = JM._dispatch_compute(
            jnp.asarray(x), jnp.asarray(one), jnp.asarray(idx),
            params["w1"], params["w3"], params["w2"], expert_lo=0,
            capacity=capacity)
        keep[:, j] = np.abs(np.asarray(out)).sum(-1) > 0
    return keep


# ---------------------------------------------------------------- layer
def test_route_matches_reference():
    params, mod = _layer()
    x = _x(1, (64, CFG.d_model))
    gate, idx, probs = JM._route(jnp.asarray(x), params["router"], CFG.top_k)
    tg, ti, tp = M.route(torch.from_numpy(x), mod.router, CFG.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    _close(tg, gate, 1e-6, 0)
    _close(tp, probs, 1e-6, 0)
    assert tg.dtype == tp.dtype == torch.float32
    torch.testing.assert_close(tg.sum(-1), torch.ones(64))


def test_route_ties_go_to_the_lower_expert():
    """Equal probabilities: the top k are the k lowest expert ids, in
    order, as jax.lax.top_k's."""
    gate, idx, _ = M.route(torch.ones(5, 8), torch.zeros(8, 6), 3)
    _, jidx, _ = JM._route(jnp.ones((5, 8)), jnp.zeros((8, 6)), 3)
    assert idx.tolist() == [[0, 1, 2]] * 5 == np.asarray(jidx).tolist()
    torch.testing.assert_close(gate, torch.full((5, 3), 1 / 3))


@pytest.mark.parametrize("factor", [8.0, 0.25])
def test_dispatch_matches_reference(factor):
    """Ample (8.0) and tight (0.25) capacity: the same kept and dropped
    assignments as the reference, and its output."""
    params, mod = _layer()
    x = _x(2, (32, CFG.d_model), 1.0)
    gate, idx, _ = JM._route(jnp.asarray(x), params["router"], CFG.top_k)
    cap = JM.capacity_for(32, CFG.num_experts, CFG.top_k, factor)
    assert M.capacity_for(32, CFG.num_experts, CFG.top_k, factor) == cap
    want = JM._dispatch_compute(jnp.asarray(x), gate, idx, params["w1"],
                                params["w3"], params["w2"], expert_lo=0,
                                capacity=cap)
    tg, ti, _ = M.route(torch.from_numpy(x), mod.router, CFG.top_k)
    got = M.dispatch_compute(torch.from_numpy(x), tg, ti, mod.w1, mod.w3,
                             mod.w2, cap)
    _close(got, want, 2e-4, 2e-5)
    keep = M.dispatch_plan(ti, CFG.num_experts, cap).keep
    ref_keep = _ref_keep(x, np.asarray(gate), np.asarray(idx), params, cap)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    if factor < 1:
        assert 0 < int((~keep).sum()) < keep.numel()  # some dropped
    else:
        assert keep.all()


def test_dispatch_plan_keeps_each_experts_first_assignments():
    """Each expert keeps its first ``capacity`` assignments in token
    order; the slots of the kept ones are distinct and in range, a
    dropped one points at the zero row E * capacity."""
    idx = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 3], [2, 0]])
    plan = M.dispatch_plan(idx, 4, 2)
    assert plan.keep.tolist() == [[True, True], [True, True], [True, False],
                                  [False, True], [True, False]]
    kept = plan.slot[plan.keep]
    assert len(set(kept.tolist())) == kept.numel() and int(kept.max()) < 8
    assert (plan.slot[~plan.keep] == 8).all()
    # expert 0's slots read tokens 0 and 1 (choice 0 of each)
    assert plan.source[0].tolist() == [0, 2]
    assert plan.filled.tolist() == [[True, True], [True, True],
                                    [True, True], [True, False]]


def test_ample_capacity_matches_dense_oracle():
    params, mod = _layer()
    x = torch.from_numpy(_x(1, (2, 8, CFG.d_model)))
    out, aux = M.moe_ffn(x, mod, CFG, capacity_factor=8.0)
    ref, aux_ref = M.moe_ffn_dense_reference(x, mod, CFG)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    jref, jaux = JM.moe_ffn_dense_reference(jnp.asarray(x.numpy()), params,
                                            JCFG)
    _close(ref, jref, 2e-4, 2e-5)
    np.testing.assert_allclose(float(aux_ref), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_moe_ffn_matches_reference(factor):
    params, mod = _layer()
    x = _x(3, (2, 16, CFG.d_model), 1.0)
    want, jaux = JM.moe_ffn(jnp.asarray(x), params, JCFG,
                            capacity_factor=factor)
    got, aux = M.moe_ffn(torch.from_numpy(x), mod, CFG,
                         capacity_factor=factor)
    _close(got, want, 2e-4, 2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert aux.dtype == torch.float32 and aux.shape == ()


def test_aux_loss_matches_reference_and_is_one_when_balanced():
    T, E = 4096, CFG.num_experts
    probs = torch.full((T, E), 1.0 / E)
    idx = torch.arange(E).repeat(T // E)[:, None].expand(T, 2)
    np.testing.assert_allclose(float(M.aux_loss(probs, idx, E)), 1.0,
                               rtol=1e-3)
    rng = np.random.default_rng(4)
    p = rng.dirichlet(np.ones(E), size=64).astype(np.float32)
    i = np.argsort(-p, axis=1)[:, :2]
    np.testing.assert_allclose(
        float(M.aux_loss(torch.from_numpy(p), torch.from_numpy(i), E)),
        float(JM._aux_loss(jnp.asarray(p), jnp.asarray(i), E)), rtol=1e-5)


def test_combine_adds_in_ascending_expert_order():
    """Each token's gated contributions are added one after the other in
    ascending expert id, in the activation dtype (the reference's
    scatter-add order): bf16 sums of exactly that order, bit for bit, and
    bitwise repeatable."""
    _, mod = _layer()
    x = torch.from_numpy(_x(5, (24, CFG.d_model), 1.0)).bfloat16()
    w = [t.bfloat16() for t in (mod.w1, mod.w3, mod.w2)]
    gate, idx, _ = M.route(x, mod.router, CFG.top_k)
    got = M.dispatch_compute(x, gate, idx, *w, capacity=64)
    assert torch.equal(got, M.dispatch_compute(x, gate, idx, *w,
                                               capacity=64))
    want = []
    for t in range(x.shape[0]):
        total = None
        for j in torch.argsort(idx[t]).tolist():
            e = int(idx[t, j])
            h = torch.nn.functional.silu(x[t:t + 1] @ w[0][e]) \
                * (x[t:t + 1] @ w[1][e])
            c = (h @ w[2][e]) * gate[t, j].bfloat16()
            total = c if total is None else total + c
        want.append(total)
    assert torch.equal(got, torch.cat(want))


def test_serving_modes_run_the_local_path():
    _, mod = _layer()
    x = torch.from_numpy(_x(6, (2, 4, CFG.d_model)))
    a, _ = M.moe_ffn(x, mod, CFG, serving_mode="weight_gather")
    b, _ = M.moe_ffn(x, mod, CFG, serving_mode="token_gather")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="serving_mode"):
        M.moe_ffn(x, mod, CFG, serving_mode="all_to_all")


def test_decode_capacity_is_the_floor_of_eight():
    """At decode T = B tokens: the capacity is 8 (the floor), not one
    computed from the prompt, so nothing is dropped."""
    assert M.capacity_for(4, 32, 8) == 8
    idx = torch.stack([torch.randperm(32, generator=torch.Generator()
                                      .manual_seed(t))[:8]
                       for t in range(4)])
    assert M.dispatch_plan(idx, 32, 8).keep.all()


# ---------------------------------------------------------------- model
def _configs(arch, **over):
    j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **over)
    t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **over)
    return j, t


class Pair:
    """One reduced MoE config in both packages on the same weights."""

    def __init__(self, arch, dtype):
        self.jcfg, self.tcfg = _configs(arch, dtype=dtype)
        self.params = jmodels.init_model(self.jcfg, jax.random.PRNGKey(0))
        self.model = convert.model_from_reference(
            jax.tree.map(np.asarray, self.params), self.tcfg, device="cpu")
        cfg = self.jcfg
        self.forward = jax.jit(lambda p, t: jmodels.forward(
            p, cfg, tokens=t, remat=False))
        self.prefill = jax.jit(lambda p, t: jmodels.prefill(p, cfg,
                                                            tokens=t))
        self.decode = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
            p, cfg, c, token=t, pos=pos))


_PAIRS = {}


def _pair(arch, dtype):
    if (arch, dtype) not in _PAIRS:
        _PAIRS[arch, dtype] = Pair(arch, dtype)
    return _PAIRS[arch, dtype]


def _tokens(cfg, seed, shape=(B, SEQ + 4)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    """Logits, and the sum of the layers' aux losses (rtol 1e-5)."""
    pair = _pair(arch, dtype)
    toks = _tokens(pair.tcfg, 1)
    want, jaux = pair.forward(pair.params, jnp.asarray(toks))
    got, aux = tmodels.forward(pair.model, tokens=torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    assert got.shape == (B, SEQ + 4, pair.tcfg.vocab_size)
    _close(got, want, TOL[dtype])
    if dtype == "float32":
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """prefill(S tokens) and its KV caches, then 4 decode steps (at T = B
    tokens, capacity 8) from them, through ``make_serve_step`` in the
    serving mode the reference's serving step takes."""
    pair = _pair(arch, dtype)
    toks = _tokens(pair.tcfg, 2)
    jl, jc = pair.prefill(pair.params, jnp.asarray(toks[:, :SEQ]))
    tl, tc = tmodels.prefill(pair.model, tokens=torch.from_numpy(
        toks[:, :SEQ]))
    _close(tl, jl, TOL[dtype])
    assert tc.keys() == jc.keys() == {"k", "v"}
    for name in tc:
        _close(tc[name], jc[name], TOL[dtype])
    caches = tmodels.init_caches(pair.tcfg, B, SEQ + 4,
                                 dtype=getattr(torch, dtype), device="cpu")
    jcache = {name: jnp.zeros(caches[name].shape, getattr(jnp, dtype))
              .at[:, :, :SEQ].set(jc[name]) for name in jc}
    for name in caches:
        caches[name][:, :, :SEQ] = tc[name]
    step = tmodels.make_serve_step(pair.model,
                                   moe_serving_mode="token_gather")
    for t in range(SEQ, SEQ + 4):
        jl, jcache = pair.decode(pair.params, jcache,
                                 jnp.asarray(toks[:, t]), jnp.asarray(t))
        tl, caches = step(caches, torch.from_numpy(toks[:, t]), t)
        _close(tl, jl, TOL[dtype])
    for name in caches:
        _close(caches[name], jcache[name], TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    pair = _pair(arch, "float32")
    prompt = _tokens(pair.tcfg, 4, (B, 8))
    want = jgenerate(pair.params, pair.jcfg, jnp.asarray(prompt), 6,
                     jax.random.PRNGKey(2), temperature=0.0)
    got = generate(pair.model, torch.from_numpy(prompt), 6, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_generate_matches_reference():
    """The ring buffer of cfg.sliding_window (64) slots, wrapped."""
    pair = _pair("granite-moe-1b-a400m", "float32")
    prompt = _tokens(pair.tcfg, 5, (1, 60))
    want = jgenerate(pair.params, pair.jcfg, jnp.asarray(prompt), 8,
                     jax.random.PRNGKey(0), temperature=0.0, window=True)
    got = generate(pair.model, torch.from_numpy(prompt), 8,
                   temperature=0.0, window=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_model_draws_the_experts():
    cfg = tconfigs.get_config("granite-moe-1b-a400m").reduced()
    model = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    again = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(a, b), name
    ffn = model.layers[0].ffn
    assert isinstance(ffn, M.MoE)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert ffn.router.shape == (d, E) and ffn.w1.shape == (E, d, f)
    assert ffn.w2.shape == (E, f, d) and ffn.w3.dtype == torch.bfloat16
    for w, scale in ((ffn.router, d ** -0.5), (ffn.w1, d ** -0.5),
                     (ffn.w3, d ** -0.5), (ffn.w2, f ** -0.5)):
        assert abs(float(w.float().std()) - scale) < 0.1 * scale


@pytest.mark.parametrize("arch,count", [
    ("granite-moe-1b-a400m", 1_384_963_072),
    ("dbrx-132b", 131_596_523_520)])
def test_full_config_parameter_count(arch, count):
    """What the reference's init_model builds, counted on ``meta``."""
    full = tmodels.Transformer(tconfigs.get_config(arch), device="meta")
    assert sum(p.numel() for p in full.parameters()) == count
    assert isinstance(full.layers[0].ffn, M.MoE)


def test_moe_modules_default_to_the_card():
    cfg = tconfigs.get_config("granite-moe-1b-a400m").reduced()
    assert M.MoE(cfg, device="meta").w1.device.type == "meta"
    assert M.MoE(cfg, device="cpu").w1.device.type == "cpu"
    if torch.cuda.is_available():
        assert M.MoE(cfg).w1.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            M.MoE(cfg)


def test_converter_rejects_mismatched_moe_trees():
    pair = _pair("granite-moe-1b-a400m", "float32")
    params = jax.tree.map(np.asarray, pair.params)
    ffn = params["layers"]["ffn"]
    bad = {**params, "layers": {**params["layers"], "ffn": {
        **ffn, "router": ffn["router"][..., :1]}}}
    with pytest.raises(ValueError, match="shape"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")
    bad = {**params, "layers": {**params["layers"], "ffn": {
        k: v for k, v in ffn.items() if k != "w3"}}}
    with pytest.raises(ValueError, match="layer leaves"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")
