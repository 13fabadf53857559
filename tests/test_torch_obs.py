"""The port's support modules against the reference: observability
(metrics, tracing, ledger records the reference's validator accepts),
flat-npz checkpoints readable by both packages, queue helpers that draw
the same numbers, device selection, and the rule that the port imports
neither JAX nor the JAX package."""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.io.checkpoint as jckpt
import repro.obs.ledger as jledger
import repro.serve.traffic as jtraffic
from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.io import checkpoint as tckpt
from repro_torch.serve import traffic as ttraffic

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax_and_no_reference():
    """Import every module of the port in a fresh interpreter and check
    that neither ``jax`` nor ``repro`` was pulled in."""
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (SRC / "repro_torch").rglob("*.py"))
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert {"repro_torch.launch.serve", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.configs.llama3_2_1b", "repro_torch.models.ssm",
            "repro_torch.kernels.mamba_scan.ops"} <= set(mods)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert torch.backends.cuda.matmul.allow_tf32 is False
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


def test_checkpoints_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"theta": rng.normal(size=(7, 4)).astype(np.float32),
            "nested": {"ids": np.arange(5, dtype=np.int32), "n": 3}}
    port = tckpt.save(str(tmp_path / "port"), {
        "theta": torch.from_numpy(tree["theta"]), "nested": tree["nested"]})
    assert port.endswith(".npz")
    back = jckpt.load_nested(port)
    np.testing.assert_array_equal(back["theta"], tree["theta"])
    np.testing.assert_array_equal(back["nested"]["ids"], tree["nested"]["ids"])
    assert int(back["nested"]["n"]) == 3
    ref = jckpt.save(str(tmp_path / "ref.npz"),
                     {"theta": jnp.asarray(tree["theta"]), "xs": [1, 2]})
    got = tckpt.load_nested(ref)
    np.testing.assert_array_equal(got["theta"], tree["theta"])
    assert int(got["xs"]["1"]) == 2


def test_ledger_records_pass_the_reference_validator(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sess = obs.configure(ledger_out=path, meta={"driver": "test",
                                                "backend": "cpu",
                                                "device_count": 1,
                                                "argv": []})
    try:
        obs.log("hello")
        obs.get_ledger().emit("serve_dispatch", envelope=[1, 8, 8, 4, "fp32"],
                              g=1, requests=1, candidates=3, occupancy=1.0,
                              wall_s=1e-3, flush_reason="direct",
                              queue_delay_us=0.0)
        with pytest.raises(ValueError):
            obs.get_ledger().emit("serve_dispatch", g=1)
    finally:
        sess.close()
    assert obs.get_ledger() is obs.NULL_LEDGER  # defaults restored
    assert jledger.validate_file(path) == []
    assert obs.validate_file(path) == []
    assert [e["kind"] for e in obs.read_jsonl(path)] == [
        "run_meta", "log", "serve_dispatch"]
    assert set(obs.SCHEMA) <= set(jledger.SCHEMA)


def test_tracer_exports_chrome_trace(tmp_path):
    tracer = obs.Tracer(enabled=True, annotate=True)
    with tracer.span("outer", g=2):
        with tracer.span("inner"):
            pass
    t = threading.Thread(target=lambda: tracer.span("worker").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    path = tracer.write(str(tmp_path / "trace.json"))
    doc = json.loads(Path(path).read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [s["name"] for s in spans] == ["inner", "outer", "worker"]
    assert spans[1]["args"] == {"g": 2}
    assert len({s["tid"] for s in spans}) == 2
    assert obs.NULL_TRACER.span("x") is obs.NULL_SPAN


def test_metrics_registry_snapshot(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("c", a="1").inc(2)
    h = reg.histogram("h")
    for v in (1e-3, 2e-3, 3e-3):
        h.observe(v)
    snap = reg.as_dict()
    assert snap["c{a=1}"]["value"] == 2.0 and snap["h"]["count"] == 3
    reg.write(str(tmp_path / "m.jsonl"))
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 2
    with pytest.raises(ValueError):
        h.quantile(99)


def test_queue_helpers_match_reference():
    np.testing.assert_array_equal(ttraffic.poisson_arrivals(50, 300.0, seed=4),
                                  jtraffic.poisson_arrivals(50, 300.0, seed=4))
    mix = {1: 3, 3: 5, 7: 50, 17: 2}
    assert ttraffic.derive_g_buckets(mix) == jtraffic.derive_g_buckets(mix)
    assert ttraffic.derive_g_buckets({}) == jtraffic.derive_g_buckets({})
    assert ttraffic.QueueConfig() == tuple(jtraffic.QueueConfig())
