"""Device layer: the share of the traced span in which no kernel, copy or
set ran on the card, 1 - busy ÷ wall (``trace.py``)."""


def read(obs):
    if obs.trace is None or obs.trace["window_s"] <= 0:
        return None
    return 1.0 - obs.trace["busy_s"] / obs.trace["window_s"]
