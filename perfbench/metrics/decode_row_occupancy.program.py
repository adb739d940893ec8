"""Runtime layer: rows served a token at each retire over the rows the
batch holds (live rows ÷ (B × retires)), over the window's retires, as
the program counts them in its own records (``program_records.py``)."""
from perfbench import program_records as pr


def read(obs):
    rec = pr.retires(obs)
    if rec is None:
        return None
    return sum(t[pr.LIVE] for t in rec) / (obs.batch * len(rec))
