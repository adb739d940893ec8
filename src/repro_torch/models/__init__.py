from repro_torch.models.transformer import (  # noqa: F401
    ApplyCtx,
    decode_step,
    forward_train,
    init_model_params,
    param_specs,
    prefill,
)
