"""Online-serving simulation on the port's ``repro_torch.serve``.

    PYTHONPATH=src python examples/serve_lsplm_torch.py
    PYTHONPATH=src python examples/serve_lsplm_torch.py --device cpu

The port of ``examples/serve_lsplm.py`` (the production story of §4): a
trained Theta is PRUNED into a deployable artifact (L1/L2,1 leave ~2-5%
of feature rows alive; only those ship), and every page view is scored
as one BUNDLE (1 user id list + N ad candidates) with the user half of
Theta^T x computed once per bundle (the serving side of Eq. 13):

  1. compress -> save -> load a pruned artifact; pruned scoring is
     bit-identical to full-Theta scoring on the sparse paths;
  2. session-shared vs naive per-ad bundle scoring (same scores, the
     shared path skips the (N-1)/N redundant user gathers);
  3. the ScoringEngine on ragged request traffic: bucketed envelopes,
     per-bucket builds made at warm-up, steady state with ZERO new ones.

Theta, the requests and the bundles come from the reference's numpy
seeds, so both packages score the same inputs. On the card the scoring
runs B1 (the fused sparse forward); on the CPU its plain version.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.data.sparse import generate_sparse
from repro_torch.device import resolve_device
from repro_torch.serve import (
    ScoreBundle,
    ScoringEngine,
    as_model,
    compress,
    load_artifact,
    save_artifact,
    score_bundles,
    score_bundles_naive,
    score_sparse,
    synthetic_requests,
)

D = 500_000  # feature columns (production width)
M = 12       # regions


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn, device, iters=50) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def make_model(d: int = D, m: int = M, nnz: float = 0.05) -> np.ndarray:
    """A production-like sparsified Theta (Table 2: few % of rows alive),
    the reference example's numpy draws."""
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(d, 2 * m)).astype(np.float32) * 0.05
    theta[rng.random(d) >= nnz] = 0.0  # exact-zero rows, like OWLQN+ leaves
    return theta


def run(device, d: int = D, rows: int = 4096, sessions: int = 64,
        requests: int = 256, iters: int = 50) -> dict:
    """The example's three parts at width ``d``; returns the scores, the
    artifact's summary, the engine's counters and the timings."""
    theta_np = make_model(d)
    theta = torch.from_numpy(theta_np).to(device)
    full = as_model(theta)  # normalised and padded once, at load time
    out = {}
    # ---- 1. pruned artifact: compress -> save -> load -> parity
    art = compress(theta)
    with tempfile.TemporaryDirectory() as tmp:
        art = load_artifact(save_artifact(os.path.join(
            tmp, "lsplm_artifact.npz"), art), device=device)
    out["alive"], out["compression"] = art.num_alive, art.compression
    out["mib"] = (theta.numel() * 4 / 2**20, art.theta.numel() * 4 / 2**20,
                  art.remap.numel() * 4 / 2**20)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, d, (rows, 24)).astype(
        np.int32)).to(device)
    vals = torch.from_numpy((rng.normal(size=(rows, 24)).astype(np.float32)
                             / 5.0)).to(device)
    p_full = score_sparse(full, ids, vals)
    p_pruned = score_sparse(art, ids, vals)
    out["p_full"], out["p_pruned"] = (p_full.cpu().numpy(),
                                      p_pruned.cpu().numpy())
    out["t_full"] = bench(lambda: score_sparse(full, ids, vals), device,
                          iters)
    out["t_pruned"] = bench(lambda: score_sparse(art, ids, vals), device,
                            iters)
    # ---- 2. session-shared vs naive per-ad bundle scoring
    batch = generate_sparse(num_features=d,
                            num_user_features_range=(3 * d // 5, d),
                            sessions=sessions, ads_per_session=30, seed=2,
                            with_plans=False, device=device)
    bundle = ScoreBundle(batch.user_ids, batch.user_vals, batch.ad_ids,
                         batch.ad_vals, batch.session_id)
    out["p_shared"] = score_bundles(art, bundle).cpu().numpy()
    out["p_naive"] = score_bundles_naive(art, bundle).cpu().numpy()
    out["candidates"] = bundle.ad_ids.shape[0]
    out["t_shared"] = bench(lambda: score_bundles(art, bundle), device, iters)
    out["t_naive"] = bench(lambda: score_bundles_naive(art, bundle), device,
                           iters)
    # ---- 3. the engine on ragged online traffic
    engine = ScoringEngine(art, device=device)
    reqs = synthetic_requests(requests, num_features=d, seed=3)
    engine.warm({engine.envelope(r) for r in reqs})  # deploy-time warm-up
    warm = engine.stats.compiles
    out["engine_scores"] = engine.score_many(reqs)
    s = engine.stats
    out["engine"] = {"requests": s.requests, "buckets": len(s.bucket_hits),
                     "compiles": s.compiles, "warm_compiles": warm,
                     "latency_us": s.latency_us,
                     "candidates_per_sec": s.candidates_per_sec}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args()
    r = run(resolve_device(args.device))
    full_mb, packed_mb, remap_mb = r["mib"]
    print(f"model: d={D:,} rows -> {r['alive']:,} alive "
          f"({r['compression']:.1%}); {full_mb:.1f} MiB -> "
          f"{packed_mb + remap_mb:.1f} MiB (rows {packed_mb:.1f} + "
          f"remap {remap_mb:.1f})")
    np.testing.assert_array_equal(r["p_full"], r["p_pruned"])
    print(f"flat sparse scoring, 4096 requests: full "
          f"{r['t_full'] * 1e6:7.1f} us, pruned {r['t_pruned'] * 1e6:7.1f} "
          "us (scores BIT-IDENTICAL)")
    np.testing.assert_allclose(r["p_shared"], r["p_naive"], rtol=1e-5,
                               atol=1e-6)
    n = r["candidates"]
    print(f"bundles: 64 page views x 30 ads = {n} candidates")
    print(f"session-shared scoring: {r['t_shared'] * 1e6:8.1f} us/batch "
          f"({n / r['t_shared']:,.0f} ads/s)")
    print(f"naive per-ad scoring  : {r['t_naive'] * 1e6:8.1f} us/batch "
          f"({n / r['t_naive']:,.0f} ads/s)")
    print(f"speedup: {r['t_naive'] / r['t_shared']:.2f}x  (scores identical)")
    e = r["engine"]
    assert e["compiles"] == e["warm_compiles"], \
        "steady state must not build anew"
    print(f"engine: {e['requests']} ragged requests over {e['buckets']} "
          f"buckets, {e['compiles']} builds (ALL during warm-up), "
          f"{e['latency_us']:.0f} us/request, "
          f"{e['candidates_per_sec']:,.0f} ads/s")


if __name__ == "__main__":
    main()
