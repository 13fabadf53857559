"""Generation demo of the PyTorch port: prefill + sampled decode.

The port's counterpart of ``examples/generate_text.py``, with the same
reduced configs and flags, plus ``--device`` (the card unless ``cpu`` is
asked for):

    PYTHONPATH=src python examples/generate_text_torch.py --device cpu
    PYTHONPATH=src python examples/generate_text_torch.py --arch olmo-1b
    PYTHONPATH=src python examples/generate_text_torch.py \
        --arch falcon-mamba-7b --device cpu
    PYTHONPATH=src python examples/generate_text_torch.py \
        --arch zamba2-2.7b --device cpu
    PYTHONPATH=src python examples/generate_text_torch.py \
        --arch granite-moe-1b-a400m --device cpu

The port serves every family: the attention families (dense, vlm,
audio), MoE (granite-moe, dbrx), the Mamba1 family (falcon-mamba) and
the Mamba2 + shared-attention hybrid (zamba2). The audio config takes
codec embeddings, not token ids, so it is refused here.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.models.generate import generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.embeds_in:
        raise SystemExit(f"{cfg.name} consumes codec embeddings, not token "
                         "ids; the port's forward/prefill take them as "
                         "embeds=")
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    t0 = time.perf_counter()
    out = generate(model, prompt, args.tokens,
                   generator=torch.Generator(device=dev).manual_seed(2),
                   temperature=args.temperature, top_k=args.top_k)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} (reduced, family={cfg.family}) on {dev}")
    for b in range(out.shape[0]):
        print(f"  prompt {prompt[b].tolist()} -> {out[b].tolist()}")
    print(f"{out.numel()} tokens in {dt:.1f}s ({out.numel() / dt:.1f} tok/s "
          f"on {dev}, untrained weights -- ids only)")


if __name__ == "__main__":
    main()
