"""Serving subsystem of the port: pruned artifacts, the session-shared
scorer, dense scoring, the bucketed engine and the micro-batching queue
(the counterpart of ``repro.serve``)."""
from repro_torch.serve.compress import (  # noqa: F401
    QuantizedArtifact,
    ServingArtifact,
    artifact_from_numpy,
    compress,
    dequantize,
    load_artifact,
    quantize,
    save_artifact,
)
from repro_torch.serve.engine import (  # noqa: F401
    BundleRequest,
    EngineStats,
    ScoringEngine,
    envelope_closure,
    synthetic_requests,
)
from repro_torch.serve.score import (  # noqa: F401
    ScoreBundle,
    ServingModel,
    as_model,
    bundle_logits,
    predict,
    score_bundles,
    score_bundles_naive,
    score_dense,
    score_sparse,
    score_sparse_logps,
)
from repro_torch.serve.traffic import (  # noqa: F401
    Completion,
    MicroBatchQueue,
    QueueConfig,
    QueueStats,
    RealClockPump,
    derive_g_buckets,
    poisson_arrivals,
    replay_open_loop,
)
