"""PyTorch/CUDA port of the LS-PLM system (the JAX package ``repro`` is the
reference it is held against).

The port keeps the reference's layout and names, so each counterpart is
easy to find (``repro_torch/serve/engine.py`` <-> ``repro/serve/engine.py``).
It imports ``torch`` and numpy only -- never ``jax`` and nothing from
``repro``. Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); see :func:`repro_torch.device.resolve_device`.

Ported so far: the serving path (pruned/int8 artifacts, the session-shared
scorer, dense scoring, the bucketed engine, the micro-batching queue and
the ``python -m repro_torch.launch.serve`` driver), sparse OWLQN+
training (padded-COO batches with transpose plans, the sparse objective,
the Eq. 9 direction, L-BFGS, OWLQN+ and ``python -m
repro_torch.launch.train --sparse``), dense OWLQN+ training (the
common-feature data, the dense and Eq. 13 objectives, the LS-PLM model
and the driver's default mode) and LM serving for every family of the
zoo (the architecture configs, the token stream, the attention, MoE,
Mamba1 and Mamba2-hybrid models' prefill and decode,
``models.generate``), on six hand-written CUDA sources
(``repro_torch/kernels/*/csrc``): the fused sparse forward in fp32 and
int8, the run-length dTheta scatter, the Eq. 9 direction, the dense
fused Eq. 2 forward, flash attention and the Mamba1 selective scan.
"""
