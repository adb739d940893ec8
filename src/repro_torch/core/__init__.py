"""The CORAL optimizer and its engines: the scalar spec (``coral``,
``evaluate``), the batched episode engine (``episode``), dCor (``dcov``),
the contract and sanitizer lanes (``contracts``, ``sanitize``) and the
host-side pieces (``space``, ``search``, ``reward``, ``drift``,
``baselines``, ``faults``)."""
from repro_torch.core.coral import CORAL, CoralState, Observation, joint_headroom  # noqa: F401
from repro_torch.core.dcov import dcor, dcor_all, dcov2  # noqa: F401
from repro_torch.core.drift import CusumDetector, DriftConfig, DriftMonitor  # noqa: F401
from repro_torch.core.episode import (  # noqa: F401
    EpisodeResult,
    run_coral_batch,
    run_drift_requests,
    run_static_requests,
)
from repro_torch.core.evaluate import (  # noqa: F401
    CellRecord,
    CellSpec,
    DriftTrace,
    RegimeTargets,
    measurements_to_feasible,
    run_cell,
    run_coral,
    run_coral_scalar,
    run_drift_regime,
    run_drift_regime_scalar,
    run_regime,
)
from repro_torch.core.reward import reward  # noqa: F401
from repro_torch.core.search import next_config  # noqa: F401
from repro_torch.core.space import (  # noqa: F401
    ConfigSpace,
    Dim,
    jetson_like_space,
    tpu_pod_space,
)
