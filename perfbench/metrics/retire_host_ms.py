"""Runtime layer: host milliseconds of a retire outside its wait on the
slot's logits (the host argmax, the per-row bookkeeping and the next
decode's dispatch: ``t_left - t_ready``), the mean over the window's
retires, from the program's own records (``program_records.py``; the
retires that held the profiler's start or stop left out)."""
from perfbench import program_records as pr


def read(obs):
    iv = pr.host_intervals(obs)
    if iv is None or not iv[0]:
        return None
    return 1e3 * sum(iv[0]) / len(iv[0])
