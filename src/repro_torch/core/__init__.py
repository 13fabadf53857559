"""LS-PLM core of the port: the model, the objective and the Eq. 8-10
direction (the counterpart of ``repro.core``). The reference's
re-exports, except the function ``objective``: here
``repro_torch.core.objective`` stays the module (the function is
``repro_torch.core.objective.objective``)."""
from repro_torch.core.lsplm import (  # noqa: F401
    LSPLMConfig,
    LSPLMParams,
    foe_mixture_proba,
    init_params,
    params_from_theta,
    predict_logits_stable,
    predict_logits_stable_sparse,
    predict_proba,
    predict_proba_sparse,
)
from repro_torch.core.objective import (  # noqa: F401
    CommonFeatureBatch,
    CTRBatch,
    is_sparse_batch,
    nll,
    nll_common_feature,
    nll_sparse,
    smooth_loss_and_grad,
)
from repro_torch.core.direction import (  # noqa: F401
    choose_orthant,
    descent_direction,
    directional_derivative,
    project_orthant,
)
