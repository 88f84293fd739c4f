"""Runtime layer (core/scheduler.py, core/executors/thread.py), dataframe
cells: the mean wait, in ms, from the later of a task's submit and the end
of the previous task's operator (the benchmark's stamp in its payload) to
the task's dispatch (the session's ``dispatch`` TraceEvent).  Moves
``rows_per_s``."""
from yardstick.readings import dispatch_waits, mean_ms, window_tasks


def read(ctx):
    ops, index = ctx["ops"], ctx["index"]
    ends = {u: ops[i]["end"] for u, i in index.items() if i in ops}
    return mean_ms(dispatch_waits(window_tasks(ctx), ends))
