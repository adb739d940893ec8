"""Device twins: hardware profiles, the analytic performance and power
models, and the simulators CORAL measures (plain numpy copies of
``repro.device``): the single-device twin and its drifting and
fault-injected wraps, the edge↔pod offload twin (``network``) and the
multi-tenant twin (``cotenant``)."""
from repro_torch.device.hw import (  # noqa: F401
    DEFAULT_HW,
    DEVICE_PROFILES,
    NO_DRIFT,
    BudgetStep,
    CotenantStep,
    DeviceProfile,
    DriftSchedule,
    DriftState,
    ThermalRamp,
    TPUv5eSpec,
    get_profile,
)
from repro_torch.device.perfmodel import (  # noqa: F401
    PerfModel,
    RooflineTerms,
    model_roofline_terms,
)
from repro_torch.device.cotenant import CotenantSimulator  # noqa: F401
from repro_torch.device.factory import build_twin  # noqa: F401
from repro_torch.device.power import PowerModel  # noqa: F401
from repro_torch.device.simulator import (  # noqa: F401
    DeviceSimulator,
    DriftingSimulator,
    FaultySimulator,
    build_cell_simulator,
    jetson_like_simulator,
    synthetic_terms,
)
