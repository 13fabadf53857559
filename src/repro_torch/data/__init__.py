"""Data of the port: dense common-feature batches, padded-COO sparse
batches and the LM token stream (the counterpart of ``repro.data``)."""
from repro_torch.data.synthetic_ctr import (  # noqa: F401
    CTRDataConfig,
    auc,
    generate,
    to_dense_batch,
    train_val_test,
)
from repro_torch.data.common_feature import (  # noqa: F401
    flops_per_eval,
    memory_bytes,
    pad_to_multiple,
    shard_sessions,
)
from repro_torch.data.sparse import (  # noqa: F401
    SparseCTRBatch,
    TransposePlan,
    build_batch_plans,
    build_transpose_plan,
    generate_sparse,
    sparse_loss_and_grad,
    sparse_nll,
    sparse_predict,
)
from repro_torch.data.tokens import (  # noqa: F401
    TokenStream,
    host_sharded_stream,
)
from repro_torch.kernels.lsplm_sparse_fused.ops import pad_theta  # noqa: F401
