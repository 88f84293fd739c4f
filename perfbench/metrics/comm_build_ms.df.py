"""Runtime layer (core/communicator.py), dataframe cells: the mean time,
in ms, the executor took to build a task's private communicator (the
session's ``comm_build`` TraceEvent) over the window's tasks.  Moves
``rows_per_s``."""
from yardstick.readings import comm_builds, mean_ms, window_tasks


def read(ctx):
    return mean_ms(comm_builds(ctx, window_tasks(ctx)))
