"""Runtime layer: rows that carried a request at each retire, over the
rows the batch holds (live rows ÷ (B × retires)), over the window's
retires. A counter of the program's ring, read at each retire."""


def read(obs):
    rec = obs.in_window(obs.retires)
    if not rec:
        return None
    return sum(r["rows"] for r in rec) / (obs.batch * len(rec))
