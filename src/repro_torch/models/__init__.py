"""The LM backbone of the port (the counterpart of ``repro.models``): every
family of the zoo (dense, vlm, audio, MoE, the Mamba1 ssm family and the
Mamba2 + shared-attention hybrid), for serving and training, and
sharded serving and training over a (data, model) mesh with
``param_specs`` / ``cache_specs`` and the port's ``cache_layout``
(``models/sharding.py``), with or without sequence parallelism and under
either ``attn_shard``."""
from repro_torch.models.transformer import (  # noqa: F401
    Block,
    MambaBlock,
    Transformer,
    cache_layout,
    cache_specs,
    chunked_cross_entropy,
    cross_entropy,
    decode_step,
    forward,
    init_caches,
    init_model,
    loss_and_grads,
    loss_fn,
    make_serve_step,
    make_train_step,
    param_specs,
    prefill,
)
