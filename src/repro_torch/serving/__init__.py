from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.runtime import (  # noqa: F401
    Request,
    ServingRuntime,
    measure_concurrency_curve,
    measure_runtime_throughput,
)
from repro_torch.serving import workload  # noqa: F401
