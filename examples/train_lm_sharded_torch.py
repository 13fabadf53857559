"""Sharded LM training on the PyTorch/CUDA port: FSDP over ``data`` and
tensor/expert parallelism over ``model``, end to end.

    PYTHONPATH=src python examples/train_lm_sharded_torch.py \
        --arch llama3.2-1b --mesh-data 2 --mesh-model 2
    PYTHONPATH=src python examples/train_lm_sharded_torch.py \
        --arch granite-moe-1b-a400m --device cpu

Starts ``data * model`` ranks (``repro_torch.launch.mesh.run_ranks``; on
one card they share it, over gloo), or joins the world ``torchrun``
started. Each rank draws the model from one seed and keeps its block of
every leaf in the training layout (``models.init_model(mesh=,
trainable=True)``): the ``param_specs`` "data" entries as FSDP, q/KV
heads, d_ff columns, Mamba1's d_inner channels and Mamba2's heads over
``model``, experts over ``model`` with their d_ff over ``data``.
``--seq-parallel`` holds the residual stream between blocks as S slices
over ``model``, and ``--attn-shard head_dim`` cuts attention's
projections by columns, every rank attending over every head. Each data shard
trains on its rows of one token batch (``make_train_step(mesh=)``); the
loss is the global batch's on every rank. Full width on the card, the
reduced config on the CPU (``--size`` overrides). Rank 0 prints the
mesh, each step's loss and ms, the all-reduces a step per group (count,
bytes, the host wall inside them), the FSDP gathers and reduce-scatters
among them, and each rank's parameter bytes and peak memory. Without a
card, ``--device cuda`` (the default) raises.
"""
import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, init_from_env, run_ranks
from repro_torch.models import init_model, make_train_step
from repro_torch.models import sharding as SH


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _config(args):
    """The config the flags ask for: the arch (reduced with ``--size
    reduced``) under the two sharding knobs."""
    cfg = get_config(args.arch)
    if args.size == "reduced":
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, seq_parallel=args.seq_parallel,
                               attn_shard=args.attn_shard)


def rank_main(rank: int, dev: torch.device, args) -> dict:
    mesh = Mesh(args.mesh_data, args.mesh_model)
    cfg = _config(args)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev, trainable=True, mesh=mesh)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    batch = TokenStream(cfg.vocab_size, seed=1).batch(args.batch,
                                                      args.seq + 1)
    rows = {k: SH.batch_rows(torch.from_numpy(v), mesh).to(dev)
            for k, v in batch.items()}
    opt, step = make_train_step(model, lr=args.lr)
    state = opt.init(dict(model.named_parameters()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    mesh.reset_counts()
    for _ in range(args.steps):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, rows)
        loss = float(m["loss"])
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = {a: {k: v / args.steps for k, v in c.items()}
              for a, c in mesh.collective_counts().items()}
    split = {k: {m: v / args.steps for m, v in c.items()}
             for k, c in mesh.split_counts().items()}
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    return {"rank": rank, "backend": mesh.backend, "cfg": cfg.name,
            "dtype": cfg.dtype, "param_bytes": param_bytes,
            "losses": losses, "ms": ms, "counts": counts, "split": split,
            "peak_gb": peak}


def _counts(c: dict) -> str:
    return ", ".join(f"{a} {v['all_reduce']:.0f} ({v['bytes'] / 1e6:.3f} MB,"
                     f" {v['seconds'] * 1e3:.2f} ms host)"
                     for a, v in c.items())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--mesh-data", type=int, default=2)
    ap.add_argument("--mesh-model", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dtype", default=None,
                    help="activation dtype (the config's by default)")
    ap.add_argument("--size", choices=("full", "reduced"), default=None,
                    help="full width (the card's default) or the reduced "
                         "config (the CPU's)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the residual stream as S slices over model")
    ap.add_argument("--attn-shard", choices=("heads", "head_dim"),
                    default="heads", help="how attention's projections are "
                    "cut over model")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if args.size is None:
        args.size = "full" if device.type == "cuda" else "reduced"
    cfg = _config(args)
    if cfg.embeds_in:
        raise SystemExit(f"{cfg.name} consumes embeddings, not token ids")
    try:
        SH.check_mesh(cfg, args.mesh_data, args.mesh_model)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    if args.batch % args.mesh_data:
        raise SystemExit(f"--batch {args.batch} does not divide by "
                         f"--mesh-data {args.mesh_data}")
    world = args.mesh_data * args.mesh_model
    if "RANK" in os.environ:  # a torchrun world
        rank, size, dev = init_from_env(device)
        if size != world:
            raise SystemExit(f"the mesh needs {world} ranks, torchrun "
                             f"started {size}")
        results = [rank_main(rank, dev, args)]
        if rank != 0:
            return
    else:
        if device.type == "cuda":
            from repro_torch.kernels import _build

            _build.build_all()  # once, before the ranks start
        results = run_ranks(rank_main, world, args, device=device)
    r0 = results[0]
    print(f"mesh: data={args.mesh_data} x model={args.mesh_model}, {world} "
          f"rank(s) on {device} (backend {r0['backend']}); {r0['cfg']} "
          f"(seq_parallel={args.seq_parallel}, attn_shard="
          f"{args.attn_shard}) "
          f"({args.size}, {r0['dtype']}), batch {args.batch} x seq "
          f"{args.seq}, lr {args.lr}")
    print("per rank: " + ", ".join(
        f"rank {r['rank']} {r['param_bytes'] / 1e6:.1f} MB of parameters"
        + (f", peak {r['peak_gb']:.2f} GB" if r["peak_gb"] is not None
           else "") for r in results))
    for i, (loss, ms) in enumerate(zip(r0["losses"], r0["ms"])):
        print(f"step {i} loss={loss:.4f} ({ms:.1f} ms)")
    print(f"all-reduces per step: {_counts(r0['counts'])}")
    print("of them FSDP (and expert d_ff) gathers and reduce-scatters: "
          + ", ".join(f"{k} {v['calls']:.0f} ({v['bytes'] / 1e6:.3f} MB)"
                      for k, v in r0["split"].items()))
    first, last = r0["losses"][0], r0["losses"][-1]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
