"""Device twins: hardware profiles, the analytic performance and power
models, and the simulators CORAL measures (plain numpy copies of
``repro.device``)."""
