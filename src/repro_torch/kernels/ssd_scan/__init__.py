from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: F401
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan  # noqa: F401
