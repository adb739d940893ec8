from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref, ssm_step_ref  # noqa: F401
from repro_torch.kernels.ssm_decode.ssm_decode import WIDTHS, ssm_decode  # noqa: F401
