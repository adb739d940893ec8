from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bhsd  # noqa: F401
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
