"""Sharded LM serving on the PyTorch/CUDA port: tensor and expert
parallelism over a (data, model) mesh, end to end.

    PYTHONPATH=src python examples/generate_text_sharded_torch.py \
        --arch llama3.2-1b --mesh-data 2 --mesh-model 2
    PYTHONPATH=src python examples/generate_text_sharded_torch.py \
        --arch granite-moe-1b-a400m --moe-serving-mode token_gather \
        --device cpu

Starts ``data * model`` ranks (``repro_torch.launch.mesh.run_ranks``; on
one card they share it, over gloo), or joins the world ``torchrun``
started. Each rank draws the model from one seed and keeps its block of
every leaf (``models.init_model(mesh=)``): q/KV heads, d_ff columns,
Mamba1's d_inner channels and Mamba2's heads over ``model``, experts
over ``model`` with their d_ff over ``data``. ``--seq-parallel`` holds
the residual stream between blocks as S slices over ``model`` in
prefill, and ``--attn-shard head_dim`` cuts attention's projections by
columns, every rank attending over every head. Each data shard prefills its rows of the prompt
and decodes greedily; the logits are gathered exactly over ``model``, so
every rank of a shard picks the same token, and the tokens are gathered
over ``data`` at the end. Full width on the card, the reduced config on
the CPU (``--size`` overrides). Rank 0 prints the mesh, each rank's
parameter bytes, prefill tokens/s, decode ms/token, the all-reduces per
group and the tokens. Without a card, ``--device cuda`` (the default)
raises.
"""
import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, init_from_env, run_ranks
from repro_torch.models import decode_step, init_caches, init_model, prefill
from repro_torch.models import sharding as SH
from repro_torch.models.generate import fill_caches
from repro_torch.models.moe import SERVING_MODES


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
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev, mesh=mesh)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    rows = SH.batch_rows(prompt, mesh)
    at = dict(mesh=mesh, moe_serving_mode=args.moe_serving_mode)
    prefill(model, tokens=rows, **at)  # warm-up
    _sync(dev)
    mesh.reset_counts()
    t0 = time.perf_counter()
    logits, c0 = prefill(model, tokens=rows, **at)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_counts = mesh.collective_counts()
    caches = fill_caches(init_caches(cfg, args.batch,
                                     args.prompt_len + args.tokens,
                                     device=dev, mesh=mesh), c0)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    mesh.reset_counts()
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        logits, caches = decode_step(model, caches, token=tok,
                                     pos=args.prompt_len + i, **at)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    steps = max(args.tokens - 1, 1)
    decode_counts = {a: {k: v / steps for k, v in c.items()}
                     for a, c in mesh.collective_counts().items()}
    tokens = mesh.gather(torch.stack(out, 1).to(torch.int32), "data", 0)
    return {"rank": rank, "param_bytes": param_bytes, "backend": mesh.backend,
            "prefill_tok_s": args.batch * args.prompt_len / prefill_s,
            "decode_ms": decode_s * 1e3 / steps,
            "prefill_counts": prefill_counts, "decode_counts": decode_counts,
            "tokens": tokens.cpu().tolist(), "cfg": cfg.name}


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
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--moe-serving-mode", default="weight_gather",
                    choices=SERVING_MODES)
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
          f"({args.size}), batch {args.batch} x prompt {args.prompt_len}, "
          f"MoE plan {args.moe_serving_mode}")
    print("parameter bytes per rank: " + ", ".join(
        f"rank {r['rank']} {r['param_bytes'] / 1e6:.1f} MB" for r in results))
    print(f"prefill {r0['prefill_tok_s']:.1f} tokens/s, decode "
          f"{r0['decode_ms']:.2f} ms/token (rank 0)")
    print(f"all-reduces per prefill: {_counts(r0['prefill_counts'])}")
    print(f"all-reduces per decode step: {_counts(r0['decode_counts'])}")
    for b, row in enumerate(r0["tokens"]):
        print(f"  row {b}: {row}")


if __name__ == "__main__":
    main()
