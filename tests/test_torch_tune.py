"""The port's autotune layer (``repro_torch.tune``, ``repro_torch.launch.
tuning``) against the reference's (``repro.tune``, ``repro.launch.
tuning``), and the knobs' call sites on the CPU.

Held against the reference: the envelope rounding over every bucket edge
and past the top, the table's JSON (a table written by either package
loads in the other with the same entries and meta), version and key
validation, the precedence explicit kwarg > ``set_overrides`` > table >
builtin default with other backends' entries ignored, the loud override
and flag validation. The port's own: the plain loops bitwise equal at
every chunk, B1/B4's and B2's knobs as the launch takes them, a
departure from the default held on Zipf ids before the table takes it,
the call sites passing the resolved knobs to the kernels'
wrappers, and the drivers printing the same numbers tuned and untuned.
"""
import argparse
import json

import numpy as np
import pytest
import torch

import repro.launch.tuning as jtuning
import repro.tune as jtune
from repro.kernels.lsplm_sparse_fused.ops import _resolve_fused
from repro_torch import tune
from repro_torch.kernels.lsplm_sparse_fused import lsplm_sparse_fused as fk
from repro_torch.kernels.lsplm_sparse_fused import ops as fops
from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
from repro_torch.kernels.lsplm_sparse_scatter.plan import (
    build_transpose_plan,
)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch import tuning as ttuning
from repro_torch.tune import sweep as tsweep

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_tables():
    """Both packages run against an explicit empty table and no overrides;
    the lazy committed-file loads are re-armed on exit."""
    for pkg in (tune, jtune):
        pkg.set_active_table(pkg.AutotuneTable())
        pkg.clear_overrides()
    yield
    for pkg in (tune, jtune):
        pkg.set_active_table(None)
        pkg.clear_overrides()


def _edges(buckets):
    top = buckets[-1]
    vals = {1, 2 * top + 1, 3 * top, 5 * top - 1}
    for b in buckets:
        vals |= {b - 1, b, b + 1}
    return sorted(v for v in vals if v > 0)


# ------------------------------------------------------------- envelopes
@pytest.mark.parametrize("name", ["N_BUCKETS", "K_BUCKETS", "M2_BUCKETS",
                                  "E_BUCKETS"])
def test_round_up_matches_reference_across_every_edge(name):
    buckets = getattr(tune, name)
    assert buckets == getattr(jtune, name)
    for x in _edges(buckets):
        assert tune.round_up(x, buckets) == jtune.round_up(x, buckets)
    for bad in (0, -3):
        for pkg in (tune, jtune):
            with pytest.raises(ValueError):
                pkg.round_up(bad, buckets)


def test_envelopes_match_reference():
    for n in _edges(tune.N_BUCKETS):
        for k in _edges(tune.K_BUCKETS):
            for m2 in (2, 8, 24, 63, 65, 130):
                assert tune.fused_envelope(n, k, m2) == \
                    jtune.fused_envelope(n, k, m2)
    for e in [0] + _edges(tune.E_BUCKETS):
        for m2 in (8, 24, 128):
            assert tune.scatter_envelope(e, m2) == \
                jtune.scatter_envelope(e, m2)


def test_backend_key():
    assert tune.backend_key("cpu") == tune.backend_key(CPU) == "cpu"
    assert jtune.backend_key() == "cpu"  # the reference, on this host
    with pytest.raises(ValueError, match="no tune backend"):
        tune.backend_key("meta")


# ----------------------------------------------------------- table JSON
def _shared_entries(pkg, backend):
    """A table of the kernels both packages key alike."""
    t = pkg.AutotuneTable()
    t.put(backend, "chunk_fwd", "n4096_k16_m24", {"chunk": 4})
    t.put(backend, "chunk_bwd", "n4096_k16_m24", {"chunk": 16})
    t.put(backend, "scatter", "e65536_m24", {"block_e": 512})
    t.meta[backend] = {"generator": "test", "reps": 3}
    return t


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_table_loads_in_the_other_package(writer, tmp_path):
    src, dst = (tune, jtune) if writer == "port" else (jtune, tune)
    t = _shared_entries(src, "cpu")
    path = tmp_path / "cpu.json"
    t.save(path, "cpu")
    got = dst.AutotuneTable.load(path)
    assert got.backends() == ("cpu",)
    assert got.entries("cpu") == t.entries("cpu")
    assert got.meta["cpu"] == t.meta["cpu"]
    assert got.to_json("cpu") == t.to_json("cpu")  # same bytes back


def test_committed_cpu_tables_load_across():
    port = json.loads((tune.TABLES_DIR / "cpu.json").read_text())
    assert port["backend"] == "cpu" and port["version"] == 1
    assert set(port["entries"]) == {"chunk_fwd", "chunk_bwd"}
    got = jtune.AutotuneTable()
    got.merge_json((tune.TABLES_DIR / "cpu.json").read_text())
    assert got.entries("cpu") == port["entries"]
    ref = tune.AutotuneTable()
    ref.merge_json((jtune.TABLES_DIR / "cpu.json").read_text())
    assert ref.entries("cpu") == jtune.AutotuneTable.load(
        jtune.TABLES_DIR / "cpu.json").entries("cpu")


def test_committed_tables_are_the_ports_backends():
    table = tune.AutotuneTable.load_dir()
    assert set(table.backends()) <= {"cpu", "cuda-sm90"}
    assert "cpu" in table.backends()
    names = {p.name for p in tune.TABLES_DIR.glob("*.json")}
    assert names <= {"cpu.json", "cuda-sm90.json"}
    if "cuda-sm90" in table.backends():
        meta = table.meta["cuda-sm90"]
        assert meta["nvidia_smi"].startswith("NVIDIA H100")
        assert "W" in meta["nvidia_smi"]
        assert meta["torch"] and meta["cuda"] and meta["generator"]
        for kernel in table.entries("cuda-sm90"):
            assert kernel in tsweep.kernels_for_backend("cuda-sm90")


def test_table_validation_matches_reference():
    for pkg in (tune, jtune):
        t = pkg.AutotuneTable()
        with pytest.raises(ValueError, match="version"):
            t.merge_json(json.dumps({"version": 2, "backend": "cpu",
                                     "entries": {}}))
        for kernel, cfg in (("chunk_fwd", {"chunk": 0}),
                            ("chunk_fwd", {"chunk": True}),
                            ("chunk_fwd", {"chunk": 2.0}),
                            ("chunk_fwd", {"chunk": 4, "extra": 1}),
                            ("chunk_bwd", {}),
                            ("scatter", {"block_e": -256}),
                            ("warp_drive", {"chunk": 4})):
            with pytest.raises(ValueError):
                t.put("cpu", kernel, "n256_k4_m4", cfg)
        with pytest.raises(ValueError):
            pkg.resolve("warp_drive", "n256_k4_m4", **(
                {"device": CPU} if pkg is tune else {}))
    # the port's B1 keys are its own: block_k has no counterpart
    with pytest.raises(ValueError, match="keys"):
        tune.AutotuneTable().put("cuda-sm90", "fused_fwd", "n256_k4_m4",
                                 {"block_n": 2, "block_k": 8})
    tune.AutotuneTable().put("cuda-sm90", "fused_fwd", "n256_k4_m4",
                             {"block_n": 2, "copy": 1})


# ----------------------------------------------------------- precedence
def test_precedence_matches_reference():
    env = "n4096_k16_m24"
    ids = torch.zeros((4096, 16), dtype=torch.int32)
    theta = torch.zeros((100, 24))
    jids = np.zeros((4096, 16), np.int32)
    jtheta = np.zeros((100, 24), np.float32)

    def both(explicit=None):
        port = (fops._chunk(ids, theta, explicit),
                sops._dvals_chunk(ids, theta, explicit))
        _, _, ref = _resolve_fused(jids, jtheta, "auto", None, None, explicit)
        return port, tuple(ref)

    # builtin defaults: chunk_fwd 8 in both; the port's chunk_bwd takes
    # all K at once (the reference's builtin is 8)
    port, ref = both()
    assert port == (8, 16) and ref == (8, 8)
    for pkg in (tune, jtune):  # another backend's entries never apply
        t = pkg.AutotuneTable()
        for kernel in ("chunk_fwd", "chunk_bwd"):
            t.put("cuda-sm90", kernel, env, {"chunk": 2})
            t.put("tpu", kernel, env, {"chunk": 2})
        pkg.set_active_table(t)
    port, ref = both()
    assert port == (8, 16) and ref == (8, 8)
    for pkg in (tune, jtune):  # a table entry beats the default
        t = pkg.AutotuneTable()
        t.put("cpu", "chunk_fwd", env, {"chunk": 16})
        t.put("cpu", "chunk_bwd", env, {"chunk": 4})
        pkg.set_active_table(t)
    port, ref = both()
    assert port == ref == (16, 4)
    for pkg in (tune, jtune):  # an override beats the table
        pkg.set_overrides(chunk=2)
    port, ref = both()
    assert port == ref == (2, 2)
    port, ref = both(explicit=32)  # an explicit kwarg beats all of it
    assert port == ref == (32, 32)
    for pkg in (tune, jtune):  # clearing one override restores the table
        pkg.set_overrides(chunk=None)
    assert both() == ((16, 4), (16, 4))


def test_resolve_fused_follows_every_change():
    """The per-shape memo never serves a stale config."""
    key = ("fused_fwd", 4000, 16, 24, CPU)
    assert tune.resolve_fused(*key) == {"block_n": None, "copy": None}
    t = tune.AutotuneTable()
    tune.set_active_table(t)
    t.put("cpu", "fused_fwd", "n4096_k16_m24", {"block_n": 2, "copy": 1})
    assert tune.resolve_fused(*key) == {"block_n": 2, "copy": 1}
    tune.set_overrides(block_n=8)
    assert tune.resolve_fused(*key) == {"block_n": 8, "copy": 1}
    tune.clear_overrides()
    tune.set_active_table(tune.AutotuneTable())
    assert tune.resolve_fused(*key) == {"block_n": None, "copy": None}
    assert tune.resolve_scatter(0, 24, CPU) == {"block_e": 256}


def test_set_overrides_validates_loudly_as_the_reference():
    for bad in ({"warp_drive": 4}, {"chunk": 0}, {"chunk": -1},
                {"block_n": True}, {"chunk": 1.5}, {"block_e": "256"}):
        for pkg in (tune, jtune):
            with pytest.raises(ValueError):
                pkg.set_overrides(**bad)
            assert pkg.get_overrides() == {}
    tune.set_overrides(block_n=4, copy=2, block_e=128, chunk=8)
    assert tune.get_overrides() == {"block_n": 4, "copy": 2, "block_e": 128,
                                    "chunk": 8}
    # a stated departure: B1 has no K tile on the card
    with pytest.raises(ValueError, match="no counterpart on the card"):
        tune.set_overrides(block_k=4)
    jtune.set_overrides(block_k=4)  # the reference's Pallas K tile


# ---------------------------------------------------------------- flags
def _args(**kw):
    ns = argparse.Namespace(block_n=None, block_k=None, chunk=None,
                            tune=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("flags,geometry", [
    ({"chunk": 0}, {}),
    ({"block_n": -2}, {}),
    ({"chunk": 32}, {"batch_k": 24}),
    ({"block_n": 8}, {"batch_n": 4}),
    ({"block_k": 16}, {"batch_k": 8}),
    ({"block_k": 0}, {}),
])
def test_apply_tuning_flags_exits_where_the_reference_does(flags, geometry):
    for mod in (ttuning, jtuning):
        with pytest.raises(SystemExit):
            mod.apply_tuning_flags(_args(**flags), **geometry)


def test_apply_tuning_flags_installs_what_both_accept():
    for mod, pkg in ((ttuning, tune), (jtuning, jtune)):
        args = _args(block_n=4, chunk=8, tune=True)
        assert mod.tuning_flags_set(args)
        assert not mod.tuning_flags_set(_args())
        mod.apply_tuning_flags(args, batch_n=16, batch_k=16)
        assert pkg.get_overrides() == {"block_n": 4, "chunk": 8}
    # the port's own: block_n off B1's grid, and any block_k
    for bad in (_args(block_n=3), _args(block_k=4)):
        with pytest.raises(SystemExit):
            ttuning.apply_tuning_flags(bad)


def test_tuning_scope_restores_the_process():
    t = tune.AutotuneTable()
    tune.set_active_table(t)
    tune.set_overrides(chunk=4)
    with ttuning.tuning_scope():
        ttuning.apply_tuning_flags(_args(block_n=2))
        tune.set_active_table(tune.AutotuneTable())
    assert tune.get_overrides() == {"chunk": 4}
    assert tune.active_table() is t


# ---------------------------------------------- the knobs change no bit
def _batch(n=300, k=40, d=500, m=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, d, (n, k)).astype(np.int32)
    ids[:, ::7] = d  # pad slots
    vals = rng.normal(size=(n, k)).astype(np.float32)
    vals[ids == d] = 0.0
    theta = fops.pad_theta(torch.from_numpy(
        rng.normal(size=(d, 2 * m)).astype(np.float32)))
    dz = torch.from_numpy(rng.normal(size=(n, 2 * m)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-127, 128, (d + 1, 2 * m)).astype(
        np.int8))
    codes[-1] = 0
    scales = torch.from_numpy(rng.random(d + 1).astype(np.float32) / 127)
    scales[-1] = 0.0
    return torch.from_numpy(ids), torch.from_numpy(vals), theta, dz, codes, \
        scales


@pytest.mark.parametrize("chunk", sorted(set(tsweep.CHUNK_GRID) | {1, 3, 40}))
def test_plain_loops_are_bitwise_equal_at_every_chunk(chunk):
    ids, vals, theta, dz, codes, scales = _batch()
    k = ids.shape[1]

    def bits(t):
        return t.view(torch.int32)

    assert torch.equal(bits(fops._chunked_zmap(ids, vals, theta, chunk)),
                       bits(fops._chunked_zmap(ids, vals, theta, 8)))
    assert torch.equal(
        bits(fops._chunked_zmap_int8(ids, vals, codes, scales, chunk)),
        bits(fops._chunked_zmap_int8(ids, vals, codes, scales, 8)))
    assert torch.equal(bits(sops.dvals_unplanned(ids, theta, dz, chunk)),
                       bits(sops.dvals_unplanned(ids, theta, dz, k)))
    with pytest.raises(ValueError, match="chunk"):
        fops._chunked_zmap(ids, vals, theta, 0)


def test_plain_calls_take_the_table_chunk_and_keep_their_bits():
    ids, vals, theta, dz, _, _ = _batch(n=64, k=24, m=12)
    theta = theta.requires_grad_(True)
    v = vals.clone().requires_grad_(True)
    z0 = fops.sparse_gather_matmul(ids, v, theta)
    g0 = torch.autograd.grad(z0.square().sum(), (theta, v))
    env = tune.fused_envelope(64, 24, 24)
    t = tune.AutotuneTable()
    t.put("cpu", "chunk_fwd", env, {"chunk": 3})
    t.put("cpu", "chunk_bwd", env, {"chunk": 5})
    tune.set_active_table(t)
    assert fops._chunk(ids, theta, None) == 3
    assert sops._dvals_chunk(ids, theta, None) == 5
    z1 = fops.sparse_gather_matmul(ids, v, theta)
    g1 = torch.autograd.grad(z1.square().sum(), (theta, v))
    assert torch.equal(z0, z1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ------------------------------ B1/B4's and B2's knobs at the launch
LANE, PIECE = tune.COPY_LANE, tune.COPY_PIECE


@pytest.mark.parametrize("block_n,copy,int8,want", [
    (None, None, False, (0, -1)), (None, None, True, (0, -1)),
    (4, LANE, False, (4, 0)), (8, PIECE, False, (8, 1)),
    (1, None, True, (1, -1)), (2, LANE, True, (2, 0))])
def test_launch_knobs_as_the_launch_takes_them(block_n, copy, int8, want):
    """A knob left None reaches the .cu as "the rule" (0 rows a block, -1
    copy scheme), which keeps the rule and the shared-memory layout; the
    rule's values and the budget are held on the card
    (``tests/test_torch_sparse_card.py``)."""
    assert fk._knob_args(block_n, copy, int8=int8) == want


def test_launch_knobs_off_the_grid_raise_before_the_card():
    for bad in (3, 16, 0):
        with pytest.raises(ValueError, match="block_n must be one of"):
            fk._knob_args(bad, None, int8=False)
    with pytest.raises(ValueError, match="copy"):
        fk._knob_args(None, 3, int8=False)
    with pytest.raises(ValueError, match="int8 rows"):
        fk._knob_args(None, PIECE, int8=True)


def test_scatter_block_sizes():
    from repro_torch.kernels.lsplm_sparse_scatter import (
        lsplm_sparse_scatter as sk,
    )

    assert sk.warps_for(None) == 8  # the 256 every launch had
    assert [sk.warps_for(e) for e in (128, 256, 512)] == [4, 8, 16]
    with pytest.raises(ValueError, match="block_e must be one of"):
        sk.warps_for(1024)


# --------------------------- a departure must hold on Zipf ids as well
@pytest.mark.parametrize("holds", [True, False])
def test_a_departure_enters_the_table_only_if_it_holds_on_zipf_ids(
        monkeypatch, holds):
    """A winner that departs from the builtin default on the reference's
    uniform ids is timed again against the default on Zipf ids, and the
    table takes it only if it wins there too by MIN_GAIN."""
    def timed(case, *, device, reps=tsweep.REPS, extra=()):
        zipf = bool(extra)  # the re-timing: the winner, then the default
        rows = []
        for cfg in list(case.grid) + [c for c in extra if c not in case.grid]:
            us = 2.0 if cfg == case.default else 1.0
            if zipf and cfg != case.default:
                us = 1.0 if holds else 3.0
            rows.append({"config": cfg, "parity": True, "us": us})
        return rows

    monkeypatch.setattr(tsweep, "sweep_case", timed)
    records = []
    table = tsweep.sweep_shapes([(64, 16, 1_000, 4)], device="cpu",
                                records=records, log=lambda msg: None)
    assert [r["kernel"] for r in records] == ["chunk_fwd", "chunk_bwd"]
    for r in records:
        assert r["best"] != r["default"]
        assert r["zipf"]["held"] is holds
        assert r["committed"] == (r["best"] if holds else r["default"])
        assert table.get("cpu", r["kernel"], r["envelope"]) == r["committed"]


def test_zipf_batch_keeps_every_draw_but_the_ids():
    uni = tsweep._make(256, 12, 5_000, 4)
    zipf = tsweep._make(256, 12, 5_000, 4, law="zipf")
    assert torch.equal(uni.vals, zipf.vals) and torch.equal(uni.dz, zipf.dz)
    assert torch.equal(uni.theta, zipf.theta)
    ids = zipf.ids.numpy()
    assert ids.min() >= 0 and ids.max() < 5_000
    assert (ids == 0).mean() > 0.2 > (uni.ids.numpy() == 0).mean()  # hot
    with pytest.raises(ValueError, match="law must be one of"):
        tsweep._make(8, 4, 100, 2, law="normal")


# ------------------------------- the call sites hand the knobs over
def test_call_sites_pass_the_resolved_knobs(monkeypatch):
    """The card paths of ``_forward``, ``_forward_int8``,
    ``bundle_forward`` and ``_scatter_card`` hand the wrappers what the
    table resolves at each launch's own shape (the wrappers are
    recorders here: this host has no card)."""
    seen = []

    def recorder(name):
        def fn(ids, vals, *rows, **kw):
            seen.append((name, tuple(ids.shape), kw))
            return None, torch.zeros((ids.shape[0], rows[0].shape[1]))
        return fn

    monkeypatch.setattr(fops, "_on_card", lambda t: True)
    monkeypatch.setattr(fops, "lsplm_sparse_fused_forward",
                        recorder("b1"))
    monkeypatch.setattr(fops, "lsplm_sparse_fused_int8_forward",
                        recorder("b4"))
    monkeypatch.setattr(sops, "lsplm_sparse_scatter",
                        lambda layout, v, z, **kw: seen.append(("b2", kw)))
    ids, vals, theta, dz, codes, scales = _batch(n=600, k=24, m=12)
    fops.sparse_gather_matmul(ids, vals, theta)
    fops.sparse_gather_matmul_int8(ids, vals, codes, scales)
    assert seen == [("b1", (600, 24), {"dedup": True, "block_n": None,
                                       "copy": None}),
                    ("b4", (600, 24), {"dedup": True, "block_n": None})]
    t = tune.AutotuneTable()
    t.put("cpu", "fused_fwd", tune.fused_envelope(600, 24, 24),
          {"block_n": 2, "copy": 2})
    t.put("cpu", "fused_fwd_int8", tune.fused_envelope(8, 16, 24),
          {"block_n": 1})
    tune.set_active_table(t)
    seen.clear()
    fops.sparse_gather_matmul(ids, vals, theta)
    session = torch.arange(8).repeat_interleave(75)
    fops.bundle_forward(ids[:8, :16], vals[:8, :16], ids, vals, session,
                        codes=codes, scales=scales)
    assert seen[0] == ("b1", (600, 24), {"dedup": True, "block_n": 2,
                                         "copy": 2})
    assert seen[1] == ("b4", (8, 16), {"dedup": True, "block_n": 1,
                                       "head": False})
    assert seen[2][0] == "b4" and seen[2][2]["block_n"] is None
    plan = build_transpose_plan(ids.numpy(), theta.shape[0],
                                pad_id=theta.shape[0] - 1)
    t.put("cpu", "scatter", tune.scatter_envelope(plan.num_kept, 24),
          {"block_e": 128})
    seen.clear()
    sops._scatter_card(plan, vals, dz)
    assert seen == [("b2", {"block_e": 128})]
    tune.set_overrides(block_n=4, block_e=512)
    seen.clear()
    fops.sparse_gather_matmul(ids, vals, theta)
    sops._scatter_card(plan, vals, dz)
    assert seen == [("b1", (600, 24), {"dedup": True, "block_n": 4,
                                       "copy": 2}),
                    ("b2", {"block_e": 512})]


# ---------------------------------------------------------- the drivers
SPARSE = ["--sparse", "--sparse-features", "50000", "--sessions", "256",
          "--regions", "4", "--lam", "0.05", "--beta", "0.05", "--iters",
          "6", "--device", "cpu"]


def _numbers(out: str) -> list[str]:
    """The f, nnz and AUC of each iteration line (walls dropped)."""
    return [line.split("(")[0].strip() for line in out.splitlines()
            if line.startswith("iter ")]


def test_tuned_sparse_training_prints_the_untuned_numbers(tmp_path, capsys):
    runs = {}
    for tag, extra in (("plain", []), ("tune", ["--tune"]),
                       ("chunk", ["--chunk", "4"]),
                       ("block_n", ["--block-n", "2"])):
        ckpt = str(tmp_path / f"{tag}.npz")
        rep = ttrain.run(SPARSE + extra + ["--ckpt", ckpt])
        out = capsys.readouterr().out
        runs[tag] = (_numbers(out), np.load(ckpt)["theta"], rep)
        if tag == "tune":
            assert "--tune: sweeping 2 job shape(s)" in out
            assert "tune/cpu/chunk_fwd/" in out
    lines, theta, _ = runs["plain"]
    assert len(lines) == 6 and "test_auc" in lines[-1]
    for tag in ("tune", "chunk", "block_n"):
        assert runs[tag][0] == lines
        np.testing.assert_array_equal(runs[tag][1].view(np.int32),
                                      theta.view(np.int32))
    assert tune.get_overrides() == {}  # the drivers leave the process as
    assert tune.active_table().backends() == ()  # they found it


def test_tuning_flags_refused_where_they_do_not_apply():
    with pytest.raises(SystemExit, match="combine them with --sparse"):
        ttrain.run(["--device", "cpu", "--iters", "1", "--tune"])
    with pytest.raises(SystemExit, match="no counterpart on the card"):
        ttrain.run(SPARSE + ["--block-k", "4"])
    with pytest.raises(SystemExit, match="exceeds the job's K"):
        ttrain.run(SPARSE + ["--chunk", "64"])


@pytest.mark.parametrize("int8", [False, True])
def test_tuned_serving_gives_equal_scores(tmp_path, int8):
    rng = np.random.default_rng(3)
    theta = (rng.normal(size=(5_000, 8)) * 0.3).astype(np.float32)
    theta[rng.random(5_000) < 0.7] = 0.0
    ckpt = tmp_path / "theta.npz"
    np.savez(ckpt, theta=theta)
    base = ["--ckpt", str(ckpt), "--requests", "24", "--device", "cpu"]
    base += ["--int8"] if int8 else []
    want = tserve.run(base)["scores"]
    for extra in (["--tune"], ["--chunk", "2", "--block-n", "1"]):
        got = tserve.run(base + extra)["scores"]
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    with pytest.raises(SystemExit, match="no counterpart on the card"):
        tserve.run(base + ["--block-k", "4"])
