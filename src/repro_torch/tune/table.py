"""Persisted kernel autotune table of the port: the one source of the
launch knobs of B1, B4 and B2 and of the plain K-chunk loops.

The port's counterpart of ``repro/tune/table.py`` (its own copy: nothing
is imported from ``repro``). A lookup keyed on ``(backend, kernel, shape
envelope)``:

  * **backend** -- :func:`backend_key` of the device the call runs on:
    ``"cpu"``, or ``"cuda-sm<major><minor>"`` from the card's compute
    capability (``"cuda-sm90"`` on an H100). A config swept on one
    backend never applies on another.
  * **kernel** -- one of :data:`KERNEL_PARAMS`:
      - ``"fused_fwd"`` (B1, ``lsplm_sparse_fused.cu``): ``block_n``, the
        rows of a block (one warp a row: 1, 2, 4 or 8), and ``copy``, how
        fp32 rows reach shared memory (:data:`COPY_LANE`, lane per row,
        or :data:`COPY_PIECE`, by piece);
      - ``"fused_fwd_int8"`` (B4): ``block_n`` (int8 rows are always
        copied lane per row);
      - ``"scatter"`` (B2, ``lsplm_sparse_scatter.cu``): ``block_e``, the
        sorted entries a block of task warps covers, 32 a warp;
      - ``"chunk_fwd"`` / ``"chunk_bwd"``: ``chunk``, the slots the plain
        forward (``_chunked_zmap*``) and the unplanned plain dvals
        (``dvals_unplanned``) gather at a time.
    Every knob changes which thread does the work, or how many slots a
    plain loop gathers at once, and never the order of a floating-point
    operation: a tuned launch is bitwise the default one.
  * **envelope** -- the shape bucket (:func:`fused_envelope`,
    :func:`scatter_envelope`), d-free as in the reference.

``block_k`` has no counterpart on the card: B1 does not tile or split K
(a warp walks a row's slots 32 at a time), so :func:`set_overrides`
refuses it (:data:`BLOCK_K_DEPARTURE`).

Resolution precedence (what a call site gets), as in the reference:

    explicit kwarg  >  set_overrides()  >  table entry  >  builtin default

A builtin default of ``None`` is "the kernel's own rule": the launch
wrapper derives the value from the shape (B1's rows a block by N and
its shared-memory budget, its copy scheme by N; all K at once for the
plain dvals), which is what every launch got before the table existed.

Tables are JSON, one file per backend, under ``tune/tables/``
(``cpu.json`` and ``cuda-sm90.json``; regenerate with ``python -m
repro_torch.tune.sweep``). The active table is loaded lazily once per
process, and :func:`resolve_fused` / :func:`resolve_scatter` keep what
they resolved per shape, so a launch pays one dict lookup: no sweep and
no file I/O on the hot path.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Mapping, Sequence

import torch

# Bucket edges for envelope rounding (the reference's): N covers
# batch-tile row counts from serving slates to full training batches,
# K/M2 the engine's id-list edges, E sorted-entry counts for the scatter.
N_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
K_BUCKETS = (4, 8, 16, 24, 32, 48, 64)
M2_BUCKETS = (4, 8, 16, 24, 32, 48, 64)
E_BUCKETS = (4096, 16384, 65536, 262144, 1048576, 4194304)

# B1's copy schemes of fp32 rows into shared memory (the ``copy`` knob)
COPY_LANE = 1   # lane t copies entry t's whole row
COPY_PIECE = 2  # neighbouring lanes copy one row's pieces

# kernel name -> the config keys a table entry for it must carry
KERNEL_PARAMS: dict[str, tuple[str, ...]] = {
    "fused_fwd": ("block_n", "copy"),
    "fused_fwd_int8": ("block_n",),
    "scatter": ("block_e",),
    "chunk_fwd": ("chunk",),
    "chunk_bwd": ("chunk",),
}

# what every launch got before the table: None is the kernel's own rule
# (see the module docstring), the rest the constants the code shipped
BUILTIN_DEFAULTS: dict[str, dict[str, int | None]] = {
    "fused_fwd": {"block_n": None, "copy": None},
    "fused_fwd_int8": {"block_n": None},
    "scatter": {"block_e": 256},
    "chunk_fwd": {"chunk": 8},
    "chunk_bwd": {"chunk": None},
}

# every overridable knob, with the kernels it applies to
_PARAM_KERNELS = {
    "block_n": ("fused_fwd", "fused_fwd_int8"),
    "copy": ("fused_fwd",),
    "block_e": ("scatter",),
    "chunk": ("chunk_fwd", "chunk_bwd"),
}

BLOCK_K_DEPARTURE = (
    "block_k has no counterpart on the card: B1 does not tile or split K "
    "(a warp walks a row's slots 32 at a time), so there is no K tile to "
    "set; the port's knobs are block_n, copy, block_e and chunk (a stated "
    "departure, ROADMAP C)")

TABLES_DIR = Path(__file__).resolve().parent / "tables"


def round_up(x: int, buckets: Sequence[int]) -> int:
    """Smallest bucket edge >= x; past the top edge, next multiple of it."""
    if x <= 0:
        raise ValueError(f"dimension must be positive, got {x}")
    for b in buckets:
        if x <= b:
            return b
    top = buckets[-1]
    return -(-x // top) * top


def fused_envelope(n: int, k: int, m2: int) -> str:
    """Envelope key for the forward-side kernels (fused_fwd*, chunk_*)."""
    return (f"n{round_up(n, N_BUCKETS)}"
            f"_k{round_up(k, K_BUCKETS)}"
            f"_m{round_up(m2, M2_BUCKETS)}")


def scatter_envelope(entries: int, m2: int) -> str:
    """Envelope key for the scatter kernel: sorted-entry count + 2m.

    ``entries`` is the layout's kept entry count (~N*K minus pads)."""
    return f"e{round_up(max(entries, 1), E_BUCKETS)}_m{round_up(m2, M2_BUCKETS)}"


@functools.cache
def _cuda_key(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda-sm{major}{minor}"


def backend_key(device: str | torch.device) -> str:
    """The table backend a call on ``device`` resolves against: ``"cpu"``,
    or ``"cuda-sm<major><minor>"`` of the card (``"cuda-sm90"``)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type == "cuda":
        return _cuda_key(torch.cuda.current_device() if dev.index is None
                         else dev.index)
    raise ValueError(f"no tune backend for device {dev}; use 'cuda' or 'cpu'")


def _check_config(kernel: str, config: Mapping[str, int]) -> dict[str, int]:
    if kernel not in KERNEL_PARAMS:
        raise ValueError(
            f"unknown kernel {kernel!r}; expected one of {sorted(KERNEL_PARAMS)}")
    want = set(KERNEL_PARAMS[kernel])
    got = set(config)
    if got != want:
        raise ValueError(
            f"kernel {kernel!r} config must have keys {sorted(want)}, got {sorted(got)}")
    for key, val in config.items():
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(f"{kernel}.{key} must be a positive int, got {val!r}")
    return dict(config)


class AutotuneTable:
    """In-memory ``(backend, kernel, envelope) -> config`` mapping with
    JSON persistence (one file per backend, the reference's layout)."""

    VERSION = 1

    def __init__(self):
        # backend -> kernel -> envelope -> {param: int}
        self._entries: dict[str, dict[str, dict[str, dict[str, int]]]] = {}
        self.meta: dict[str, dict] = {}  # backend -> provenance blob

    def put(self, backend: str, kernel: str, envelope: str,
            config: Mapping[str, int]) -> None:
        cfg = _check_config(kernel, config)
        self._entries.setdefault(backend, {}).setdefault(kernel, {})[envelope] = cfg
        _memo.clear()

    def get(self, backend: str, kernel: str, envelope: str) -> dict[str, int] | None:
        """The stored config, or None (:func:`resolve` owns the fallback
        chain)."""
        cfg = self._entries.get(backend, {}).get(kernel, {}).get(envelope)
        return dict(cfg) if cfg is not None else None

    def backends(self) -> tuple[str, ...]:
        return tuple(sorted(self._entries))

    def entries(self, backend: str) -> dict[str, dict[str, dict[str, int]]]:
        """``kernel -> envelope -> config`` for one backend (a copy)."""
        return {k: {e: dict(c) for e, c in envs.items()}
                for k, envs in self._entries.get(backend, {}).items()}

    # ----------------------------------------------------------- JSON I/O
    def to_json(self, backend: str) -> str:
        doc = {
            "version": self.VERSION,
            "backend": backend,
            "entries": self.entries(backend),
            "meta": self.meta.get(backend, {}),
        }
        return json.dumps(doc, indent=2, sort_keys=True) + "\n"

    def merge_json(self, text: str) -> str:
        """Merge one backend file into this table; returns the backend."""
        doc = json.loads(text)
        if doc.get("version") != self.VERSION:
            raise ValueError(f"unsupported table version {doc.get('version')!r}")
        backend = doc["backend"]
        for kernel, envs in doc.get("entries", {}).items():
            for envelope, cfg in envs.items():
                self.put(backend, kernel, envelope, cfg)
        if doc.get("meta"):
            self.meta[backend] = doc["meta"]
        return backend

    def save(self, path: str | Path, backend: str) -> None:
        Path(path).write_text(self.to_json(backend))

    @classmethod
    def load(cls, *paths: str | Path) -> "AutotuneTable":
        table = cls()
        for p in paths:
            table.merge_json(Path(p).read_text())
        return table

    @classmethod
    def load_dir(cls, directory: str | Path = TABLES_DIR) -> "AutotuneTable":
        """Load every ``*.json`` backend file under ``directory``."""
        return cls.load(*sorted(Path(directory).glob("*.json")))


# ------------------------------------------------- process-wide resolution
_active_table: AutotuneTable | None = None
_overrides: dict[str, int] = {}
# (kernel, shape, device) -> resolved config; cleared whenever the table,
# its entries or the overrides change
_memo: dict[tuple, dict[str, int | None]] = {}


def active_table() -> AutotuneTable:
    """The process-wide table, lazily loaded from the committed files
    ONCE (missing/empty dir -> empty table, builtin defaults apply)."""
    global _active_table
    if _active_table is None:
        try:
            _active_table = AutotuneTable.load_dir()
        except (OSError, ValueError):
            _active_table = AutotuneTable()
    return _active_table


def set_active_table(table: AutotuneTable | None) -> None:
    """Install a table (``--tune`` fresh sweeps, tests); None re-arms the
    lazy load of the committed files."""
    global _active_table
    _active_table = table
    _memo.clear()


def set_overrides(**params: int | None) -> None:
    """Process-wide knob overrides (the launch ``--block-n``/``--chunk``
    flags): beat the table, lose to explicit call kwargs. ``chunk``
    applies to both chunk_fwd and chunk_bwd. A value of None clears that
    override. Unknown knobs and non-positive/non-int values raise --
    never silently clamped -- and so does ``block_k``
    (:data:`BLOCK_K_DEPARTURE`)."""
    if params.get("block_k") is not None:
        raise ValueError(BLOCK_K_DEPARTURE)
    params.pop("block_k", None)
    for key, val in params.items():
        if key not in _PARAM_KERNELS:
            raise ValueError(
                f"unknown tunable {key!r}; expected one of {sorted(_PARAM_KERNELS)}")
        if val is None:
            continue
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(f"override {key}={val!r} must be a positive int")
    for key, val in params.items():
        if val is None:
            _overrides.pop(key, None)
        else:
            _overrides[key] = val
    _memo.clear()


def clear_overrides() -> None:
    _overrides.clear()
    _memo.clear()


def get_overrides() -> dict[str, int]:
    return dict(_overrides)


def resolve(kernel: str, envelope: str, *,
            device: str | torch.device) -> dict[str, int | None]:
    """The config a call site on ``device`` should run with -- builtin
    defaults, beaten by the active table's ``(backend, kernel,
    envelope)`` entry, beaten by :func:`set_overrides`."""
    if kernel not in KERNEL_PARAMS:
        raise ValueError(
            f"unknown kernel {kernel!r}; expected one of {sorted(KERNEL_PARAMS)}")
    cfg = dict(BUILTIN_DEFAULTS[kernel])
    entry = active_table().get(backend_key(device), kernel, envelope)
    if entry is not None:
        cfg.update(entry)
    for param in KERNEL_PARAMS[kernel]:
        if param in _overrides:
            cfg[param] = _overrides[param]
    return cfg


def resolve_fused(kernel: str, n: int, k: int, m2: int,
                  device: torch.device) -> dict[str, int | None]:
    """:func:`resolve` at a forward-side shape (N rows, K slots, 2m
    columns), kept per shape: after the first call at a shape, one dict
    lookup. The returned dict is shared; do not change it."""
    key = (kernel, n, k, m2, device.type, device.index)
    cfg = _memo.get(key)
    if cfg is None:
        cfg = _memo[key] = resolve(
            kernel, fused_envelope(max(n, 1), max(k, 1), m2), device=device)
    return cfg


def resolve_scatter(entries: int, m2: int,
                    device: torch.device) -> dict[str, int | None]:
    """:func:`resolve` of the scatter kernel at ``entries`` sorted entries
    and 2m columns, kept per shape like :func:`resolve_fused`."""
    key = ("scatter", entries, m2, device.type, device.index)
    cfg = _memo.get(key)
    if cfg is None:
        cfg = _memo[key] = resolve(
            "scatter", scatter_envelope(entries, m2), device=device)
    return cfg
