"""Kernel autotune subsystem of the port: swept launch knobs behind B1,
B4 and B2 and the plain K-chunk loops.

The port's counterpart of ``repro/tune``. ``repro_torch.tune.table`` holds
the persisted ``(backend, kernel, envelope) -> config`` table the sparse
ops resolve their knobs from; ``repro_torch.tune.sweep`` regenerates it
(timed and parity-gated). See the README "Autotuning" section.
"""
from repro_torch.tune.table import (  # noqa: F401
    AutotuneTable,
    BLOCK_K_DEPARTURE,
    BUILTIN_DEFAULTS,
    COPY_LANE,
    COPY_PIECE,
    E_BUCKETS,
    K_BUCKETS,
    KERNEL_PARAMS,
    M2_BUCKETS,
    N_BUCKETS,
    TABLES_DIR,
    active_table,
    backend_key,
    clear_overrides,
    fused_envelope,
    get_overrides,
    resolve,
    resolve_fused,
    resolve_scatter,
    round_up,
    scatter_envelope,
    set_active_table,
    set_overrides,
)
