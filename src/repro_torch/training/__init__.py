from repro_torch.training.adamw import AdamWConfig  # noqa: F401
from repro_torch.training.data import SyntheticLM, multimodal_extras  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    cross_entropy,
    loss_fn,
    make_eval_step,
    make_train_step,
)
