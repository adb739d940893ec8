"""Engine layer: device milliseconds per decode call (one graph replay and
its token upload), between CUDA events recorded on the stream before and
after it, over the window's decode calls."""


def read(obs):
    rec = obs.in_window(obs.decodes)
    if not rec or any(r["device_s"] is None for r in rec):
        return None
    return 1e3 * sum(r["device_s"] for r in rec) / len(rec)
