"""Dataframe layer (dataframe/ops_dist.py, ops_local.py, comm.py): the mean
host time, in ms, of one distributed operator and a synchronise, taken
inside the benchmark's payload, over the window's tasks.  Moves
``rows_per_s``."""
from yardstick.readings import mean_ms, window_tasks


def read(ctx):
    index = ctx["index"]
    ops = [ctx["ops"][index[t.uid]] for t in window_tasks(ctx)
           if index[t.uid] in ctx["ops"]]
    return mean_ms([o["end"] - o["start"] for o in ops])
