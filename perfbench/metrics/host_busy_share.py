"""Runtime layer: the share of the window the serving loop's host spent
on retires outside their waits (``t_left - t_ready``) and on prefill
dispatches, from the program's own records (``program_records.py``; the
calls that held the profiler's start or stop left out of both the sum
and the window). Near 1, the host sets the pace and the device waits
for it."""
from perfbench import program_records as pr


def read(obs):
    iv = pr.host_intervals(obs)
    if iv is None:
        return None
    retire_s, prefill_s, left_out = iv
    return (sum(retire_s) + sum(prefill_s)) / (obs.t_end - obs.t0 - left_out)
