from repro_torch.kernels.dcov.dcov import (  # noqa: F401
    dcov_gram,
    dcov_gram_windows,
    dcov_sums,
)
from repro_torch.kernels.dcov.ops import dcor_all_blocked, dcor_blocked  # noqa: F401
from repro_torch.kernels.dcov.ref import (  # noqa: F401
    dcor_from_sums,
    dcor_ref,
    dcov_gram_ref,
    dcov_gram_windows_ref,
    dcov_sums_ref,
)
