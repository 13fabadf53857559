"""Distributed sparse LS-PLM on the PyTorch/CUDA port: the paper's
worker/server split, end to end.

    PYTHONPATH=src python examples/train_sparse_sharded_torch.py
    PYTHONPATH=src python examples/train_sparse_sharded_torch.py --device cpu

The port's counterpart of ``examples/train_sparse_sharded.py``. Starts a
(data=2, model=4) mesh of 8 ranks (``repro_torch.launch.mesh.run_ranks``;
on one card they share it, over gloo) and trains the padded-COO sparse
path on it:

  * workers (``data``): each data rank holds half of the sessions;
  * servers (``model``): each model rank owns a contiguous id RANGE of
    Theta's rows (``repro_torch.shard.make_partition``); ids are bucketed
    per range on the host (``route_batch``), so each rank's gathers (B1)
    and plan-driven scatter (B2) run on its own rows, and the Eq. 9
    direction (B3) on its own rows of the direction. Across ranks go one
    all-reduce of the (B, 2m) region-logit partials per loss evaluation
    over ``model``, the NLL and the dTheta block over ``data``, and the
    optimizer's scalar dots over ``model``.

The batch's transpose plans are not rebuilt per rank: its id sort is
sliced at the id-range boundaries (``repro_torch.shard.plan_slicing``).
Rank 0 gathers Theta, scores the held-out batch and prints.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.sparse import generate_sparse, sparse_predict
from repro_torch.device import resolve_device
from repro_torch.dist import make_distributed_step, shard_sparse_batch
from repro_torch.eval.metrics import auc
from repro_torch.launch.mesh import make_debug_mesh, run_ranks
from repro_torch.optim.owlqn_plus import OWLQNPlus
from repro_torch.shard import make_partition, make_sharded_sparse_loss

D, M = 200_000, 4
MESH_DATA, MESH_MODEL = 2, 4
ITERS = 30


def rank_main(rank: int, dev: torch.device) -> dict:
    mesh = make_debug_mesh(data=MESH_DATA, model=MESH_MODEL)
    user_range = (int(0.6 * D), D)
    part = make_partition(D, MESH_MODEL)
    routed = generate_sparse(num_features=D,
                             num_user_features_range=user_range,
                             sessions=512, seed=1, shards=part,
                             data_shards=MESH_DATA, device="cpu")
    cell = shard_sparse_batch(mesh, routed, dev)
    theta0 = torch.from_numpy((0.01 * np.random.default_rng(0).normal(
        size=(D, 2 * M))).astype(np.float32))
    block = part.shard_rows(part.pad_rows(theta0), mesh.model_rank).to(dev)
    loss_and_grad, loss = make_sharded_sparse_loss(cell, mesh)
    opt = OWLQNPlus(loss_and_grad, lam=0.05, beta=0.05, loss=loss)
    step = make_distributed_step(opt, mesh)
    if rank == 0:
        print(f"mesh: data={MESH_DATA} x model={MESH_MODEL}, {mesh.size} "
              f"ranks on {dev} (backend {mesh.backend}); Theta ({D:,} x "
              f"{2 * M}) id-range sharded at {part.rows_per_shard:,} "
              f"rows/rank")
        print(f"routed: user ids (S,G,K)={tuple(routed.user_ids.shape)}, "
              f"ad ids={tuple(routed.ad_ids.shape)}; this rank's cell: "
              f"{cell.batch.ad_plan.num_kept:,} ad entries")
    state = opt.init(block)
    t0 = time.perf_counter()
    for k in range(ITERS):
        state, stats = step(state)
        if rank == 0 and (k % 5 == 0 or k == ITERS - 1):
            print(f"iter {k:3d}  f={stats.f_new:12.2f} "
                  f"alpha={stats.alpha:.3g} nnz={stats.nnz:8d}")
    dt = time.perf_counter() - t0
    theta = part.unpad_rows(mesh.gather_rows(state.theta))  # every rank
    if rank != 0:
        return {}
    test = generate_sparse(num_features=D, num_user_features_range=user_range,
                           sessions=64, seed=2, device=dev)
    p = sparse_predict(theta, test).cpu().numpy()
    return {"seconds": dt, "auc": float(auc(test.y.cpu().numpy(), p)),
            "counts": mesh.collective_counts()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()  # once, before the ranks start
    out = run_ranks(rank_main, MESH_DATA * MESH_MODEL, device=device)[0]
    c = out["counts"]
    print(f"trained {ITERS} sharded iterations in {out['seconds']:.1f}s; "
          f"rank 0 issued {c['model']['all_reduce']} model and "
          f"{c['data']['all_reduce']} data all-reduces")
    print(f"test AUC={out['auc']:.4f}")
    print("note: the ranks share this machine's one device, so the mesh "
          "shows the distribution plan, not a speedup; parity with the "
          "single-device path is held in tests/test_torch_shard_step.py")


if __name__ == "__main__":
    main()
