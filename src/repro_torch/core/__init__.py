"""The CORAL optimizer and its engines: the scalar spec (``coral``,
``evaluate``), the batched episode engine (``episode``), dCor (``dcov``)
and the host-side pieces (``space``, ``search``, ``reward``, ``drift``,
``baselines``, ``faults``)."""
