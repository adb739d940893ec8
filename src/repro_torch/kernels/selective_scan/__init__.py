from repro_torch.kernels.selective_scan.ref import selective_scan_ref, selective_step_ref  # noqa: F401
from repro_torch.kernels.selective_scan.selective_scan import STATES, selective_scan  # noqa: F401
