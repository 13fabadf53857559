"""PyTorch/CUDA port of the LS-PLM system (the JAX package ``repro`` is the
reference it is held against).

The port keeps the reference's layout and names, so each counterpart is
easy to find (``repro_torch/serve/engine.py`` <-> ``repro/serve/engine.py``).
It imports ``torch`` and numpy only -- never ``jax`` and nothing from
``repro``. Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); see :func:`repro_torch.device.resolve_device`.

Ported so far: the serving path (pruned/int8 artifacts, the session-shared
scorer, the bucketed engine, the micro-batching queue and the
``python -m repro_torch.launch.serve`` driver) on two hand-written CUDA
kernels (``repro_torch/kernels/lsplm_sparse_fused/csrc``).
"""
