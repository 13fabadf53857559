"""Train a reduced transformer backbone on the synthetic LM stream with
the PyTorch port: AdamW, the token pipeline, the checkpointed blocks.

The port's counterpart of ``examples/train_lm_backbone.py``, with the
same reduced configs and flags, plus ``--device`` (the card unless
``cpu`` is asked for):

    PYTHONPATH=src python examples/train_lm_backbone_torch.py --device cpu --steps 10
    PYTHONPATH=src python examples/train_lm_backbone_torch.py --arch zamba2-2.7b

On the card the attention forward is B6 and the Mamba1 scan B7; both
backwards are their plain versions' gradients, recomputed.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import init_model, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_model(cfg, gen, device=dev, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} (reduced) on {dev}: {n_params / 1e6:.2f}M params")

    opt, train_step = make_train_step(model, lr=3e-3)
    opt_state = opt.init(dict(model.named_parameters()))
    stream = TokenStream(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)

    losses = []
    for i in range(args.steps):
        b = stream.batch(args.batch, args.seq + 1)
        if cfg.embeds_in:  # audio-style: embeddings stub instead of tokens
            batch = {"embeds": (0.1 * rng.normal(
                         size=(args.batch, args.seq, cfg.d_model))
                     ).astype(np.float32),
                     "labels": b["labels"][:, :args.seq] % cfg.vocab_size}
        else:
            batch = {"tokens": b["tokens"], "labels": b["labels"]}
        t0 = time.perf_counter()
        opt_state, metrics = train_step(opt_state, batch)
        losses.append(float(metrics["ce"]))
        if i % 5 == 0:
            print(f"step {i:3d}  ce={losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    print(f"ce: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
