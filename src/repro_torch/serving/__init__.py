from repro_torch.serving.engine import (  # noqa: F401
    ServingEngine,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serving.runtime import (  # noqa: F401
    Request,
    ServingRuntime,
    measure_concurrency_curve,
    measure_runtime_throughput,
)
from repro_torch.serving.controller import (  # noqa: F401
    IntervalRecord,
    ServingController,
    build_serving_record,
)
from repro_torch.serving import workload  # noqa: F401
