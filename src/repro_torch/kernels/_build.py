"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Every ``kernels/<name>/csrc/<source>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/repro_torch_kernels/<source>-<hash>.so``
at the root of the checkout, on first use. The hash covers the source,
the headers beside it and the flags, so an edited kernel rebuilds and an
unchanged one loads straight away. The libraries expose a plain C
interface (raw pointers, ints and the CUDA stream), so no PyTorch header
is compiled: a build takes seconds, not minutes. Nothing but the repo's
sources and the CUDA toolkit is used.

``build_all()`` starts one ``nvcc`` per stale source, all at once, and
waits for them together; ``load(source)`` builds (if needed) and loads one
library. Both run only when a CUDA kernel is about to be launched --
importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """``{source stem: path}`` of every CUDA source of the port."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc")


def library_path(source: Path) -> Path:
    """Where ``source`` builds to, keyed by a hash of its text, the
    headers in its directory and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` each, all started together. ``nvcc``'s own output (the
    ``-Xptxas -v`` register and spill report) lands next to each library
    as ``<library>.log``. Returns ``{name: library path}``; raises with
    the compiler's output when a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else names
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KeyError(f"no CUDA source named {missing}; have {sorted(srcs)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(srcs[n]) for n in names}
    jobs = []
    for name in names:
        target = out[name]
        if target.is_file():
            continue
        tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        jobs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, target, tmp, proc in jobs:
        log, _ = proc.communicate()
        target.with_name(target.name + ".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):"
                            f"\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of CUDA source ``name`` (built on first use)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LOADED[name] = lib
        return lib
