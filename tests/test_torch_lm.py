"""The port's LM serving path (``repro_torch.models``) against the JAX
reference (``repro.models``) on the same weights and tokens, on the CPU.

Both packages get the reference's ``init_model`` parameters, as numpy
arrays through ``convert.model_from_reference``, at the reduced configs
of three dense flavours: ``llama3.2-1b`` (GQA, tied embeddings),
``olmo-1b`` (non-parametric layer norm) and ``qwen1.5-32b`` (qkv bias).
Bars: logits within 1e-4 at ``dtype="float32"``; within 5e-2 in bf16
(``tests/test_archs_smoke.py:137``); greedy tokens equal at fp32; the
int8 KV cache within ``tests/test_int8_kv.py:34``'s 0.2; token batches
bit-equal. The reference's attention here is its jnp chunked path; the
port's is B6's plain version on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data.tokens as jtokens
import repro.models as jmodels
from repro.models.generate import generate as jgenerate
import repro_torch.configs as tconfigs
import repro_torch.data.tokens as ttokens
import repro_torch.models as tmodels
from repro_torch.models import layers as tlayers
from repro_torch import convert
from repro_torch.models.generate import generate, sample_logits

ARCHS = ["llama3.2-1b", "olmo-1b", "qwen1.5-32b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 12


def _configs(arch, **over):
    j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **over)
    t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **over)
    return j, t


class Pair:
    """One reduced config in both packages on the same weights, with the
    reference's entry points jitted once."""

    def __init__(self, arch, dtype):
        self.jcfg, self.tcfg = _configs(arch, dtype=dtype)
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


def _pair(arch, dtype):
    if (arch, dtype) not in _PAIRS:
        _PAIRS[arch, dtype] = Pair(arch, dtype)
    return _PAIRS[arch, dtype]


def _tokens(cfg, seed, shape=(B, S + 4)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- configs
def test_configs_equal_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES
    for arch in jconfigs.list_archs():
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(
            j.reduced())
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        for shape in jconfigs.INPUT_SHAPES:
            assert (tconfigs.uses_sliding_window(t, shape)
                    == jconfigs.uses_sliding_window(j, shape))
            assert (tconfigs.decode_cache_len(t, shape)
                    == jconfigs.decode_cache_len(j, shape))
    # param_count() leaves out the norm scales; the model holds them too
    full = tmodels.Transformer(tconfigs.get_config("llama3.2-1b"),
                               device="meta")
    assert sum(p.numel() for p in full.parameters()) == 1_235_814_400
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


def test_token_stream_equals_reference():
    for a, b in ((ttokens.TokenStream(512, seed=3),
                  jtokens.TokenStream(512, seed=3)),
                 (ttokens.host_sharded_stream(300, 4, 2, seed=1),
                  jtokens.host_sharded_stream(300, 4, 2, seed=1))):
        for shape in ((2, 17), (3, 1)):
            ta, jb = a.batch(*shape), b.batch(*shape)
            assert ta.keys() == jb.keys()
            for key in ta:
                assert ta[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(ta[key], jb[key])


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    pair = _pair(arch, dtype)
    toks = _tokens(pair.tcfg, 1)
    want = pair.forward(pair.params, jnp.asarray(toks))
    got, aux = tmodels.forward(pair.model, tokens=torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, S + 4, pair.tcfg.vocab_size) and float(aux) == 0
    _close(got, want, TOL[dtype])
    hidden, _ = tmodels.forward(pair.model, tokens=torch.from_numpy(toks),
                                return_hidden=True)
    assert hidden.shape == (B, S + 4, pair.tcfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """prefill(S tokens), the caches it fills, then 4 decode steps into
    caches of S + 4 slots (in the activation dtype)."""
    pair = _pair(arch, dtype)
    toks = _tokens(pair.tcfg, 2)
    jl, jc = pair.prefill(pair.params, jnp.asarray(toks[:, :S]))
    tl, tc = tmodels.prefill(pair.model, tokens=torch.from_numpy(
        toks[:, :S]))
    _close(tl, jl, TOL[dtype])
    assert tc.keys() == jc.keys()
    for name in tc:
        assert tc[name].shape == jc[name].shape
        _close(tc[name], jc[name], TOL[dtype])

    kv = getattr(jnp, dtype)
    jcache = jmodels.init_caches(pair.jcfg, B, S + 4, dtype=kv)
    jcache = {k: v.at[:, :, :S].set(jc[k]) for k, v in jcache.items()}
    tcache = tmodels.init_caches(pair.tcfg, B, S + 4,
                                 dtype=getattr(torch, dtype), device="cpu")
    for name in tcache:
        tcache[name][:, :, :S] = tc[name]
    for t in range(S, S + 4):
        jl, jcache = pair.decode(pair.params, jcache,
                                 jnp.asarray(toks[:, t]), jnp.asarray(t))
        tl, tcache = tmodels.decode_step(pair.model, tcache,
                                         token=torch.from_numpy(toks[:, t]),
                                         pos=t)
        assert tl.shape == (B, pair.tcfg.vocab_size)
        _close(tl, jl, TOL[dtype])
    for name in tcache:
        _close(tcache[name], jcache[name], TOL[dtype])


def test_prefill_then_decode_equals_forward():
    """The serving invariant inside the port (fp32): decode at position S
    after prefill of S tokens gives forward's logits at position S."""
    model = _pair("llama3.2-1b", "float32").model
    toks = torch.from_numpy(_tokens(model.cfg, 3))
    full, _ = tmodels.forward(model, tokens=toks[:, :S + 1])
    _, c0 = tmodels.prefill(model, tokens=toks[:, :S])
    caches = tmodels.init_caches(model.cfg, B, S + 1, dtype=torch.float32,
                                 device="cpu")
    for name in caches:
        caches[name][:, :, :S] = c0[name]
    step = tmodels.make_serve_step(model)
    logits, _ = step(caches, toks[:, S], S)
    torch.testing.assert_close(logits, full[:, S], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ generate
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    pair = _pair(arch, "float32")
    prompt = _tokens(pair.tcfg, 4, (B, 8))
    want = jgenerate(pair.params, pair.jcfg, jnp.asarray(prompt), 6,
                     jax.random.PRNGKey(2), temperature=0.0)
    got = generate(pair.model, torch.from_numpy(prompt), 6, temperature=0.0)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prompt_len,new", [(60, 8), (70, 4)])
def test_window_generate_matches_reference(prompt_len, new):
    """Sliding-window decode (reduced window 64): a ring buffer that
    wraps (60 + 8 > 64), and a prompt longer than the window, where the
    prompt-length cache is kept."""
    pair = _pair("llama3.2-1b", "float32")
    assert pair.tcfg.sliding_window == 64
    prompt = _tokens(pair.tcfg, 5, (B, prompt_len))
    want = jgenerate(pair.params, pair.jcfg, jnp.asarray(prompt), new,
                     jax.random.PRNGKey(2), temperature=0.0, window=True)
    got = generate(pair.model, torch.from_numpy(prompt), new,
                   temperature=0.0, window=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_kv_cache_matches_reference():
    """qwen1.5 reduced with kv_cache_dtype="int8", decoded token by token
    from empty caches: within test_int8_kv.py's bar of the reference's
    int8 decode, and of the port's own bf16-cache decode."""
    jcfg, tcfg = _configs("qwen1.5-32b", kv_cache_dtype="int8")
    pair = _pair("qwen1.5-32b", "bfloat16")
    model8 = convert.model_from_reference(
        jax.tree.map(np.asarray, pair.params), tcfg, device="cpu")
    decode8 = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
        p, jcfg, c, token=t, pos=pos))
    toks = _tokens(tcfg, 6)
    jc = jmodels.init_caches(jcfg, B, 32)
    tc = tmodels.init_caches(tcfg, B, 32, device="cpu")
    t16 = tmodels.init_caches(pair.tcfg, B, 32, device="cpu")
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.bfloat16
    assert tc.keys() == jc.keys()
    agree = 0
    for t in range(S):
        jl, jc = decode8(pair.params, jc, jnp.asarray(toks[:, t]),
                         jnp.asarray(t))
        tl, tc = tmodels.decode_step(model8, tc,
                                     token=torch.from_numpy(toks[:, t]),
                                     pos=t)
        l16, t16 = tmodels.decode_step(pair.model, t16,
                                       token=torch.from_numpy(toks[:, t]),
                                       pos=t)
        assert torch.isfinite(tl.float()).all()
        _close(tl, jl, 0.2)
        torch.testing.assert_close(tl.float(), l16.float(), rtol=0.2,
                                   atol=0.2)
        agree += int((tl.argmax(-1) == l16.argmax(-1)).all())
    assert agree >= S - 1, f"top-1 agreement {agree}/{S}"
    np.testing.assert_array_equal(tc["k"][:, :, :S].abs().amax(-1).numpy(),
                                  np.full((tcfg.num_layers, B, S,
                                           tcfg.num_kv_heads), 127))


# --------------------------------------------------- port-only behaviour
def test_sample_logits_greedy_and_top_k():
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    greedy = sample_logits(logits, temperature=0.0)
    assert greedy.dtype == torch.int32
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))
    top3 = torch.topk(logits, 3, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        tok = sample_logits(logits, g, temperature=1.5, top_k=3).long()
        assert (tok[:, None] == top3).any(-1).all()
        seen.update(tok.tolist())
    assert len(seen) > 4  # draws, not the argmax every time
    a = sample_logits(logits, torch.Generator().manual_seed(1), 1.0, 5)
    b = sample_logits(logits, torch.Generator().manual_seed(1), 1.0, 5)
    assert torch.equal(a, b)


def test_sampled_generate_is_seeded():
    model = _pair("llama3.2-1b", "float32").model
    prompt = torch.from_numpy(_tokens(model.cfg, 8, (B, 5)))

    def run(seed):
        return generate(model, prompt, 4,
                        generator=torch.Generator().manual_seed(seed),
                        temperature=0.8, top_k=20)

    assert torch.equal(run(3), run(3))
    assert run(3).shape == (B, 4)


def test_init_model_draws_from_the_generator():
    cfg = tconfigs.get_config("olmo-1b").reduced()

    def draw(seed):
        return tmodels.init_model(cfg, torch.Generator().manual_seed(seed),
                                  device="cpu")

    a, b = draw(0), draw(0)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, draw(1).embed)
    assert a.layers[0].norm1 is None and a.final_norm is None  # olmo
    assert a.embed.dtype == torch.bfloat16
    std = float(a.layers[0].ffn.w2.float().std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.init_model(cfg, torch.Generator())


def test_transformer_defaults_to_the_card():
    """The module itself resolves its device as the entry points do:
    ``cuda`` unless the CPU is asked for; ``meta`` allocates nothing."""
    cfg = tconfigs.get_config("llama3.2-1b").reduced()
    assert tmodels.Transformer(cfg, device="cpu").device.type == "cpu"
    assert tmodels.Transformer(cfg, device="meta").device.type == "meta"
    if torch.cuda.is_available():
        assert tmodels.Transformer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.Transformer(cfg)


def test_layer_modules_default_to_the_card():
    """Attention, MLP and Block resolve their device as Transformer does:
    cuda unless the CPU is asked for; meta allocates nothing."""
    cfg = tconfigs.get_config("llama3.2-1b").reduced()
    for make in (lambda d: tlayers.Attention(cfg, torch.bfloat16, d),
                 lambda d: tlayers.MLP(cfg, torch.bfloat16, d),
                 lambda d: tmodels.Block(cfg, d)):
        assert next(make("cpu").parameters()).device.type == "cpu"
        assert next(make("meta").parameters()).device.type == "meta"
        if torch.cuda.is_available():
            assert next(make(None).parameters()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make(None)


def test_converter_rejects_mismatched_trees():
    pair = _pair("llama3.2-1b", "float32")
    params = jax.tree.map(np.asarray, pair.params)
    with pytest.raises(ValueError, match="top-level"):
        convert.model_from_reference({**params, "lm_head": params["embed"]},
                                     pair.tcfg, device="cpu")
    bad = {**params, "layers": {**params["layers"],
                                "norm1": params["layers"]["norm1"][:1]}}
    with pytest.raises(ValueError, match="layers"):
        convert.model_from_reference(bad, pair.tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-2b"])
def test_embedding_inputs_match_reference(arch):
    """The audio (frame embeddings in, GELU MLP) and vlm (patch
    embeddings in front of the tokens) families at fp32: forward and
    prefill logits against the reference."""
    jcfg, tcfg = _configs(arch, dtype="float32")
    params = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    model = convert.model_from_reference(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    rng = np.random.default_rng(9)
    emb = (0.1 * rng.normal(size=(B, 10, tcfg.d_model))).astype(np.float32)
    if tcfg.embeds_in:
        jkw, tkw = {"embeds": jnp.asarray(emb)}, {"embeds": emb}
    else:
        toks = _tokens(tcfg, 10, (B, 6))
        jkw = {"prefix_embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks)}
        tkw = {"prefix_embeds": emb, "tokens": toks}
    want, _ = jax.jit(lambda p: jmodels.forward(p, jcfg, remat=False,
                                                **jkw))(params)
    got, _ = tmodels.forward(model, **tkw)
    _close(got, want, TOL["float32"])
    last, _ = tmodels.prefill(model, **tkw)
    _close(last, want[:, -1], TOL["float32"])
