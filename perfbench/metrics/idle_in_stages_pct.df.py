"""Dataframe layer (dataframe/ops_dist.py), dataframe cells: the share, in
%, of the traced sub-window in which the device is idle while a window
task's ``df.*`` stage span is open (target, pack, exchange, compact, local
sort, join): idle time while the host issues an operator's stages.  The
stage spans are host spans of issue, put on the device trace's clock by the
program's ``wall_offset_ns``.  Disjoint from ``idle_between_tasks_pct.df``;
both are parts of ``idle_pct.df``.  Moves ``rows_per_s``."""
from yardstick.program_spans import idle_pct_vs_spans


def read(ctx):
    return idle_pct_vs_spans(ctx, lambda k: k.startswith("df."), inside=True)
