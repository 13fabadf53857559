"""The LM backbone of the port (the counterpart of ``repro.models``): every
family of the zoo (dense, vlm, audio, MoE, the Mamba1 ssm family and the
Mamba2 + shared-attention hybrid), for serving.
The training names of the reference (``cross_entropy``, ``loss_fn``,
``make_train_step``, ``param_specs``) wait for the LM training slice and
for sharding."""
from repro_torch.models.transformer import (  # noqa: F401
    Block,
    MambaBlock,
    Transformer,
    decode_step,
    forward,
    init_caches,
    init_model,
    make_serve_step,
    prefill,
)
