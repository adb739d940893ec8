from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    body_for,
    body_launches,
    flash_attention_bhsd,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
