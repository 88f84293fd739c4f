"""Runtime layer (core/scheduler.py, core/executors/thread.py), dataframe
cells: the share, in %, of the traced sub-window in which the device is
idle and no window task's ``compute`` span is open (the program's spans put
on the device trace's clock by its ``wall_offset_ns``): idle time between
tasks.  Disjoint from ``idle_in_stages_pct.df``; both are parts of
``idle_pct.df``.  Moves ``rows_per_s``."""
from yardstick.program_spans import idle_pct_vs_spans, kind


def read(ctx):
    return idle_pct_vs_spans(ctx, kind("compute"))
