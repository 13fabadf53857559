"""Time ablated copies of B7's backward kernel on the card.

Where does ``csrc/mamba_scan_bwd.cu`` spend its time? This script copies
the source into a temporary directory, cuts one part out of each copy by
a textual edit, builds every copy with the port's own nvcc flags (all at
once), and times each through the port's wrapper at one shape, beside
the full kernel:

* ``pass1``: pass 1 alone (the forward scan writing the checkpoints; in
  the G-lane design a kernel of its own, the walk's kernel returning at
  once);
* ``pass1+recompute``: pass 1, then each chunk recomputed, no walk back;
* ``no-channel-sums``: the whole kernel without its sums over channels
  (one design's warp butterflies, folded in-register instead; the
  other's chunk reduction, skipped);
* ``no-prologue-sfu``: the per-(channel, step) exponentials, log and
  divisions (softplus, silu, sigma) replaced by plain products (one
  design runs them in its walk, the other in its chunk prologue);
* ``no-recompute-expf``, ``no-pass2-barriers``, ``no-lane-folds`` (the
  G-lane design only): its recompute without expf, its pass 2 without
  the two block barriers a chunk, its sums over n without the shuffles
  across a channel's lanes.

The ablated copies exist only in the temporary directory. Their outputs
are wrong by design and are not checked. The package on ``PYTHONPATH``
provides the wrapper, so the script times whichever design that package
holds (point it at another checkout's ``src`` to time an older one)::

    PYTHONPATH=src python tools/b7_backward_ablation.py [--batch 4]
        [--seq 4096] [--di 8192] [--state 16] [--dtype bfloat16]
        [--group G] [--runs 10]

Needs a CUDA card and nvcc. Prints one line per copy and, last, a JSON
object of the medians in ms.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# (text of the source, what replaces every occurrence), by copy; a copy
# applies each edit whose text the source holds and fails if none matched
EDITS = {
    "pass1": [("  // ---- pass 2:", "  return;\n  // ---- pass 2:"),
              ("  // the chunks from the last, recomputed, then walked back",
               "  return;\n"
               "  // the chunks from the last, recomputed, then walked back")],
    "pass1+recompute": [("for (int j = TC - 1; j >= 0; --j) {",
                         "for (int j = -1; j >= 0; --j) {")],
    "no-channel-sums": [
        ("warp_sums<N>(red, lane, ", "fold_sums<N>(red, lane, "),
        ("// a warp's sums of V values into row[0..V): one lane writes each",
         "// the ablation's stand-in for warp_sums: the values folded in\n"
         "// registers, lane 0 writes their sum\n"
         "template <int V>\n"
         "__device__ __forceinline__ void fold_sums(float (&v)[V], int lane,\n"
         "                                          float* row) {\n"
         "  float s = v[0];\n"
         "#pragma unroll\n"
         "  for (int k = 1; k < V; ++k) s = __fadd_rn(s, v[k]);\n"
         "  if (lane == 0) row[0] = s;\n"
         "}\n\n"
         "// a warp's sums of V values into row[0..V): one lane writes each"),
        ("    if (p.part_bc != nullptr) {\n      for (int rho = warp;",
         "    if (false) {\n      for (int rho = warp;"),
    ],
    # the chunk prologue's SFU work (softplus, silu's exp, the three
    # divisions) replaced by plain products
    "no-prologue-sfu": [
        ("const float dtv = softplus_e(vraw, &ev);",
         "const float dtv = (ev = vraw);"),
        ("const float en = expf(-zv);", "const float en = zv;"),
        ("__fdiv_rn(", "__fmul_rn("),
    ],
    # the recompute's exponential replaced by its argument
    "no-recompute-expf": [
        ("dav[kk] = expf(__fmul_rn(p0.x, a[kk]));",
         "dav[kk] = __fmul_rn(p0.x, a[kk]);"),
    ],
    # pass 2's two block barriers a chunk left out (the results race)
    "no-pass2-barriers": [
        ("    __syncthreads();  // s_p and s_bc written; the last chunk's "
         "sums read\n", ""),
        ("    __syncthreads();  // the chunk's terms written\n", ""),
    ],
    # the sums over n stop at the lane's own states (no shuffles)
    "no-lane-folds": [("  return lane_fold<G / 2>(q[0]);",
                       "  return q[0];")],
}


def ablated(text: str, name: str) -> str | None:
    """``text`` with copy ``name`` 's edits, or None when none of them
    matches this design's source."""
    hits = 0
    for old, new in EDITS[name]:
        if old in text:
            text = text.replace(old, new)
            hits += 1
    return text if hits else None


def build(sources: dict[str, str], tmp: Path) -> dict[str, Path]:
    """Each source text built into a library in ``tmp``, one nvcc each,
    all at once; raises with the compiler's output on a failure."""
    from repro_torch.kernels import _build

    procs = {}
    for name, text in sources.items():
        src = tmp / f"{name.replace('+', '_')}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        out[name] = lib
    return out


def inputs(B, S, di, N, dtype, dev):
    """The gated scan's inputs as the model gives them (B and C slices of
    one projection, z half of another), dy; no h0, no dhT."""
    gen = torch.Generator(device=dev).manual_seed(42)

    def f(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    xdb, xz = f(B, S, 256 + 2 * N, dt=dtype), f(B, S, 2 * di, dt=dtype)
    args = [f(B, S, di, dt=dtype), f(di) - 3, f(B, S, di, dt=dtype),
            xdb[..., 256:256 + N], xdb[..., 256 + N:], 0.5 * f(di, N), f(di),
            xz[..., di:], None]
    return args, f(B, S, di, dt=dtype)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--di", type=int, default=8192)
    ap.add_argument("--state", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--group", type=int, default=None)
    ap.add_argument("--runs", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan as tk

    dev = torch.device("cuda")
    source = _build.sources()["mamba_scan_bwd"]
    text = source.read_text()
    texts = {"full": text}
    for name in EDITS:
        cut = ablated(text, name)
        if cut is None:
            print(f"{name}: not in this design (no edit matches)")
        else:
            texts[name] = cut
    kw = {}
    if a.group is not None:
        if "group" not in inspect.signature(
                tk.mamba1_scan_gated_backward).parameters:
            raise SystemExit("--group: this design has no G")
        kw["group"] = a.group
    args, dy = inputs(a.batch, a.seq, a.di, a.state, getattr(torch, a.dtype),
                      dev)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(texts, Path(tmp))
        load = _build.load
        try:
            for name, lib in libs.items():
                _build.load = lambda _, path=lib: ctypes.CDLL(str(path))
                tk._bwd_lib.cache_clear()
                tk._bwd_lib()

                def run():
                    return tk.mamba1_scan_gated_backward(*args, dy, None, **kw)

                run()
                torch.cuda.synchronize()
                ms = []
                for _ in range(a.runs):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run()
                    end.record()
                    end.synchronize()
                    ms.append(start.elapsed_time(end))
                times[name] = sorted(ms)[len(ms) // 2]
                print(f"{name}: {times[name]:.3f} ms (median of {a.runs}) at "
                      f"(B, S, di, N) = {(a.batch, a.seq, a.di, a.state)} "
                      f"{a.dtype}{'' if not kw else f', G = {a.group}'}")
        finally:
            _build.load = load
            tk._bwd_lib.cache_clear()
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
