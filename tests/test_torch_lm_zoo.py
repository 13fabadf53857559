"""The zoo's serving paths that the other LM parity files leave out: the
port (``repro_torch.models``) against the JAX reference (``repro.models``)
on the CPU, on the same weights (the reference's ``init_model``, as numpy
arrays through ``convert.model_from_reference``) and the same numpy
inputs.

* mistral-nemo-12b reduced with its head_dim kept at 128: d 256, H 4,
  KVH 2, so H * hd = 512 != d, as at full width (wq (5,120, 4,096), wo
  (4,096, 5,120)), where ``reduced()`` alone would make them equal;
* musicgen-medium decoding frame embeddings (``embed=``) after a prefill
  of embeddings;
* internvl2-2b decoding after a prefill with patch embeddings in front
  of the tokens;
* a sliding-window decode at positions 524,280-524,287 (the reference's
  ``long_500k`` decode, its 8,192-slot ring cut to the reduced 64), and
  an int8 KV cache inside a ring that wraps;
* for all ten configs at full width, the port's leaf shapes on the
  ``meta`` device against the reference's under ``jax.eval_shape``.

Bars as ``tests/test_torch_lm.py``'s: logits within 1e-4 at fp32 and
5e-2 in bf16 (``tests/test_archs_smoke.py:137``), greedy tokens equal,
the int8 cache within ``tests/test_int8_kv.py:34``'s 0.2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.models import layers as jlayers
from repro.models.generate import generate as jgenerate
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.models import layers as tlayers
from repro_torch.models.generate import fill_caches, generate

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
INT8_TOL = 0.2  # tests/test_int8_kv.py:34
B, S = 2, 12
NEMO = {"head_dim": 128}  # H * hd = 512 against d_model = 256
LONG_500K = 524_288  # the reference's long_500k decode position, + 1


def _configs(arch, **over):
    j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **over)
    t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **over)
    return j, t


_PAIRS = {}


def _pair(arch, dtype, **over):
    """(reference config, port config, reference params, port model) of
    a reduced ``arch`` on the same weights, made once per case."""
    key = (arch, dtype, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jcfg, tcfg = _configs(arch, dtype=dtype, **over)
        params = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
        model = convert.model_from_reference(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _PAIRS[key] = jcfg, tcfg, params, model
    return _PAIRS[key]


def _tokens(cfg, seed, shape=(B, S + 4)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _embeds(cfg, seed, n):
    """(B, n, d) embeddings at the embedding table's scale, d^-0.5."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n, cfg.d_model))
            * cfg.d_model ** -0.5).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _jdecode(jcfg, window=False):
    return jax.jit(lambda p, c, pos, t=None, e=None: jmodels.decode_step(
        p, jcfg, c, token=t, embed=e, pos=pos, window=window))


def _decode_buffers(jcfg, tcfg, jc, tc, n, dtype):
    """Both packages' decode caches of ``n`` slots holding prefill's
    caches ``jc`` / ``tc`` in their first positions."""
    kv = getattr(jnp, dtype)
    jcache = jmodels.init_caches(jcfg, B, n, dtype=kv)
    jcache = {k: v.at[:, :, :jc[k].shape[2]].set(jc[k].astype(kv))
              for k, v in jcache.items()}
    tcache = fill_caches(tmodels.init_caches(
        tcfg, B, n, dtype=getattr(torch, dtype), device="cpu"), tc)
    return jcache, tcache


# ------------------------------------------- mistral-nemo, H * hd != d
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nemo_forward_matches_reference(dtype):
    jcfg, tcfg, params, model = _pair("mistral-nemo-12b", dtype, **NEMO)
    hd, H, KVH, d = 128, tcfg.num_heads, tcfg.num_kv_heads, tcfg.d_model
    assert H * hd == 512 != d
    attn = model.layers[0].attn
    assert tuple(attn.wq.shape) == (d, H * hd)
    assert tuple(attn.wk.shape) == tuple(attn.wv.shape) == (d, KVH * hd)
    assert tuple(attn.wo.shape) == (H * hd, d)
    toks = _tokens(tcfg, 1)
    want, _ = jax.jit(lambda p, t: jmodels.forward(p, jcfg, tokens=t,
                                                   remat=False))(
        params, jnp.asarray(toks))
    got, _ = tmodels.forward(model, tokens=torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nemo_prefill_and_decode_match_reference(dtype):
    """prefill(S tokens), its (L, B, S, KVH, 128) caches, then 4 decode
    steps into caches of S + 4 slots."""
    jcfg, tcfg, params, model = _pair("mistral-nemo-12b", dtype, **NEMO)
    toks = _tokens(tcfg, 2)
    jl, jc = jax.jit(lambda p, t: jmodels.prefill(p, jcfg, tokens=t))(
        params, jnp.asarray(toks[:, :S]))
    tl, tc = tmodels.prefill(model, tokens=torch.from_numpy(toks[:, :S]))
    _close(tl, jl, TOL[dtype])
    assert tc.keys() == jc.keys()
    for name in tc:
        assert tuple(tc[name].shape) == (tcfg.num_layers, B, S,
                                          tcfg.num_kv_heads, 128)
        _close(tc[name], jc[name], TOL[dtype])
    jcache, tcache = _decode_buffers(jcfg, tcfg, jc, tc, S + 4, dtype)
    decode = _jdecode(jcfg)
    for t in range(S, S + 4):
        jl, jcache = decode(params, jcache, jnp.asarray(t),
                            t=jnp.asarray(toks[:, t]))
        tl, tcache = tmodels.decode_step(model, tcache, pos=t,
                                         token=torch.from_numpy(toks[:, t]))
        _close(tl, jl, TOL[dtype])
    for name in tcache:
        _close(tcache[name], jcache[name], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nemo_greedy_generate_matches_reference(dtype):
    jcfg, tcfg, params, model = _pair("mistral-nemo-12b", dtype, **NEMO)
    prompt = _tokens(tcfg, 4, (B, 8))
    want = jgenerate(params, jcfg, jnp.asarray(prompt), 6,
                     jax.random.PRNGKey(2), temperature=0.0)
    got = generate(model, torch.from_numpy(prompt), 6, temperature=0.0)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nemo_weights_round_trip_through_the_reference_layout():
    """``params_to_reference`` gives back the reference's tree, shapes
    and (fp32 weights) bits, the decoupled head_dim included."""
    _, tcfg, params, model = _pair("mistral-nemo-12b", "float32", **NEMO)
    back = convert.params_to_reference(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert back["layers"]["attn"]["wo"].shape == (tcfg.num_layers, 512, 256)


# ---------------------------------------------- embeddings in, decode
def test_musicgen_decodes_embeddings_like_reference():
    """Frame embeddings in: prefill of 10, then 4 decode steps through
    ``decode_step(embed=)`` and ``make_serve_step``, at fp32."""
    jcfg, tcfg, params, model = _pair("musicgen-medium", "float32")
    assert tcfg.embeds_in and tcfg.mlp_type == "gelu"
    emb = _embeds(tcfg, 11, 14)
    jl, jc = jax.jit(lambda p, e: jmodels.prefill(p, jcfg, embeds=e))(
        params, jnp.asarray(emb[:, :10]))
    tl, tc = tmodels.prefill(model, embeds=emb[:, :10])
    _close(tl, jl, TOL["float32"])
    jcache, tcache = _decode_buffers(jcfg, tcfg, jc, tc, 14, "float32")
    decode, step = _jdecode(jcfg), tmodels.make_serve_step(model)
    for t in range(10, 14):
        jl, jcache = decode(params, jcache, jnp.asarray(t),
                            e=jnp.asarray(emb[:, t]))
        tl, tcache = step(tcache, torch.from_numpy(emb[:, t]), t)
        _close(tl, jl, TOL["float32"])
    full, _ = tmodels.forward(model, embeds=emb)
    _close(tl, full[:, -1].numpy(), TOL["float32"])


def test_internvl2_decodes_after_prefix_like_reference():
    """Patch embeddings in front of the tokens: prefill of 8 + 6, caches
    of 14 positions, then greedy decode steps at positions 14-17 against
    the reference's, and the last against the port's own forward."""
    jcfg, tcfg, params, model = _pair("internvl2-2b", "float32")
    P = tcfg.num_prefix_embeds
    assert P == 8
    pre, toks = _embeds(tcfg, 12, P), _tokens(tcfg, 12, (B, 6))
    jl, jc = jax.jit(lambda p, t, e: jmodels.prefill(
        p, jcfg, tokens=t, prefix_embeds=e))(params, jnp.asarray(toks),
                                             jnp.asarray(pre))
    tl, tc = tmodels.prefill(model, tokens=toks, prefix_embeds=pre)
    _close(tl, jl, TOL["float32"])
    assert tc["k"].shape[2] == P + 6
    jcache, tcache = _decode_buffers(jcfg, tcfg, jc, tc, P + 10, "float32")
    decode = _jdecode(jcfg)
    fed = []
    tok = tl.argmax(-1).to(torch.int32)
    assert torch.equal(tok, torch.from_numpy(np.asarray(jl).argmax(-1)).int())
    for t in range(P + 6, P + 10):
        fed.append(tok)
        jl, jcache = decode(params, jcache, jnp.asarray(t),
                            t=jnp.asarray(tok.numpy()))
        tl, tcache = tmodels.decode_step(model, tcache, token=tok, pos=t)
        _close(tl, jl, TOL["float32"])
        tok = tl.argmax(-1).to(torch.int32)
        assert torch.equal(tok, torch.from_numpy(
            np.asarray(jl).argmax(-1)).int())
    full, _ = tmodels.forward(model, prefix_embeds=pre, tokens=np.concatenate(
        [toks, torch.stack(fed, 1).numpy()], axis=1))
    _close(tl, full[:, -1].numpy(), TOL["float32"])


# ------------------------------------------- the window and int8 rings
def _reference_rope(jcfg):
    """The reference's rope tables as its jitted decode makes them, in
    place of the port's ``layers.rope_cos_sin`` (for the same config)."""
    hd, theta = jcfg.resolved_head_dim, jcfg.rope_theta
    tables = jax.jit(lambda p: jlayers.rope_cos_sin(p, hd, theta))

    def rope_cos_sin(positions, head_dim, th):
        assert (head_dim, th) == (hd, theta)
        cos, sin = tables(jnp.asarray(positions.numpy(), jnp.int32))
        return (torch.from_numpy(np.array(cos)),
                torch.from_numpy(np.array(sin)))
    return rope_cos_sin


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmo-1b",
                                  "mistral-nemo-12b", "qwen1.5-32b"])
def test_rope_near_2_19_parts_by_two_ulps_of_the_angle(arch):
    """The fp32 angle pos * inv_freq has an ulp of 2^-5 at positions
    524,280-524,287 (~5e5 rad). The port's tables are cos/sin of its fp32
    angle to fp32 rounding; the reference's jitted ones part from them by
    up to two ulps of the angle at every position: its compiled inverse
    frequencies are rounded from exact values, the port's (and the
    reference's eager ones) come from an fp32 ``pow``, one or two ulps
    apart in some columns, ~0.03 in cos near 2^19 (``ROADMAP.md`` C, a
    departure)."""
    cfg = tconfigs.get_config(arch)
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    pos = np.concatenate([np.arange(0, 4096, 97),
                          np.arange(LONG_500K - 8, LONG_500K)])
    cos, sin = tlayers.rope_cos_sin(torch.from_numpy(pos), hd, theta)
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    angle = pos[:, None].astype(np.float32) * inv.numpy()
    np.testing.assert_allclose(cos.numpy(), np.cos(angle.astype(np.float64)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(angle.astype(np.float64)),
                               rtol=0, atol=1e-6)
    jcos, jsin = _reference_rope(jconfigs.get_config(arch))(
        torch.from_numpy(pos), hd, theta)
    ulp = np.spacing(angle)
    assert float(ulp.max()) == 2.0 ** -5
    assert np.all(np.abs(jcos.numpy() - cos.numpy()) <= 2 * ulp + 1e-6)
    assert np.all(np.abs(jsin.numpy() - sin.numpy()) <= 2 * ulp + 1e-6)


def test_window_decode_near_2_19_matches_reference(monkeypatch):
    """A ring of ``sliding_window`` (64) slots filled by a prefill of 64
    tokens, then window decode steps at positions 524,280-524,287 (the
    last the reference's long_500k position), the port on the
    reference's rope tables (the test above bounds how the two packages'
    tables part there)."""
    jcfg, tcfg, params, model = _pair("mistral-nemo-12b", "float32", **NEMO)
    W = tcfg.sliding_window
    assert W == 64
    toks = _tokens(tcfg, 13, (B, W + 8))
    jl, jc = jax.jit(lambda p, t: jmodels.prefill(p, jcfg, tokens=t))(
        params, jnp.asarray(toks[:, :W]))
    _, tc = tmodels.prefill(model, tokens=toks[:, :W])
    jcache, tcache = _decode_buffers(jcfg, tcfg, jc, tc, W, "float32")
    decode = _jdecode(jcfg, window=True)
    monkeypatch.setattr(tlayers, "rope_cos_sin", _reference_rope(jcfg))
    for i, pos in enumerate(range(LONG_500K - 8, LONG_500K)):
        tok = toks[:, W + i]
        jl, jcache = decode(params, jcache, jnp.asarray(pos, jnp.int32),
                            t=jnp.asarray(tok))
        tl, tcache = tmodels.decode_step(model, tcache, pos=pos,
                                         token=torch.from_numpy(tok),
                                         window=True)
        _close(tl, jl, TOL["float32"])
    for name in tcache:
        _close(tcache[name], jcache[name], TOL["float32"])


def test_int8_ring_matches_reference():
    """mistral-nemo (hd 128) with ``kv_cache_dtype="int8"`` decoded token
    by token from empty caches into a ring of 8 slots, 12 steps (it wraps
    at step 8): within the int8 bar of the reference's int8 ring and of
    the port's own bf16 ring, top-1 agreeing on all but one step, and
    every slot written holding a code of magnitude 127 per (token,
    head)."""
    jcfg, tcfg = _configs("mistral-nemo-12b", kv_cache_dtype="int8", **NEMO)
    _, t16cfg, params, model16 = _pair("mistral-nemo-12b", "bfloat16",
                                       **NEMO)
    model8 = convert.model_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    ring, toks = 8, _tokens(tcfg, 14)
    jc = jmodels.init_caches(jcfg, B, ring)
    tc = tmodels.init_caches(tcfg, B, ring, device="cpu")
    t16 = tmodels.init_caches(t16cfg, B, ring, device="cpu")
    assert tc.keys() == jc.keys() and tc["k"].dtype == torch.int8
    decode = _jdecode(jcfg, window=True)
    agree = 0
    for t in range(S):
        tok = torch.from_numpy(toks[:, t])
        jl, jc = decode(params, jc, jnp.asarray(t), t=jnp.asarray(toks[:, t]))
        tl, tc = tmodels.decode_step(model8, tc, token=tok, pos=t,
                                     window=True)
        l16, t16 = tmodels.decode_step(model16, t16, token=tok, pos=t,
                                       window=True)
        assert torch.isfinite(tl.float()).all()
        _close(tl, jl, INT8_TOL)
        _close(tl, l16.float(), INT8_TOL)
        agree += int((tl.argmax(-1) == l16.argmax(-1)).all())
    assert agree >= S - 1, f"top-1 agreement {agree}/{S}"
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (tcfg.num_layers, B, ring,
                                         tcfg.num_kv_heads, 128)
        np.testing.assert_array_equal(
            tc[name].abs().amax(-1).numpy(),
            np.full(tc[name].shape[:-1], 127))
        _close(tc[name].float(), np.asarray(jc[name], np.float32), 1.0)


# ------------------------------------------ full-width leaf shapes
def _port_leaf_shapes(model) -> dict:
    """{reference path: shape} of a port model's leaves, in the
    reference's layout (``convert``'s key map: layers stacked on a
    leading L axis, the hybrid's shared block unstacked)."""
    out = {(name,): tuple(p.shape)
           for name, p in convert._top_level(model).items()}
    per_layer = [convert._leaves(blk) for blk in model.layers]
    for key, p in per_layer[0].items():
        assert all(tuple(leaves[key].shape) == tuple(p.shape)
                   for leaves in per_layer)
        out[("layers",) + key] = (len(per_layer),) + tuple(p.shape)
    if model.shared is not None:
        out.update({("shared",) + key: tuple(p.shape) for key, p in
                    convert._leaves(model.shared).items()})
    return out


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_full_width_leaf_shapes_match_reference(arch):
    """No memory is allocated on either side: the port's ``Transformer``
    on ``meta``, the reference's ``init_model`` under ``jax.eval_shape``."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    tree = jax.eval_shape(lambda k: jmodels.init_model(jcfg, k),
                          jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}
    model = tmodels.Transformer(tcfg, device="meta")
    assert _port_leaf_shapes(model) == want
    if arch == "mistral-nemo-12b":
        assert want["layers", "attn", "wq"] == (40, 5120, 4096)
        assert want["layers", "attn", "wo"] == (40, 4096, 5120)
        assert sum(p.numel() for p in model.parameters()) == 12_247_782_400
