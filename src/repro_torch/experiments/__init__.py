"""The scenario grid and the static matrix runner (the static part of
``repro.experiments``)."""
