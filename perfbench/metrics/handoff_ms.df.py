"""Runtime layer (core/scheduler.py, core/executors/thread.py), dataframe
cells: the mean time, in ms, from the end of one window task's ``compute``
span (the thread executor's span around the payload) to the start of the
next one's, over consecutive window tasks: the done event, the scheduler's
handling, the next launch, its thread's start and its ``comm_build``.  The
cells run one task at a time on all ranks.  Moves ``rows_per_s``."""
from yardstick.program_spans import kind, window_spans
from yardstick.readings import mean_ms


def read(ctx):
    comp = window_spans(ctx, kind("compute"))
    return mean_ms([b["t0"] - a["t1"] for a, b in zip(comp, comp[1:])])
