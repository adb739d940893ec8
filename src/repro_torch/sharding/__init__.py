from repro_torch.sharding.specs import (  # noqa: F401
    RULE_SETS,
    Spec,
    activation_sharding,
    batch_spec,
    cache_shardings,
    data_axes,
    distribute,
    distribute_tree,
    param_shardings,
    placements,
    spec_for_axes,
)
