"""Device, jamba2-mini.longdoc: ``idle_pct.sat``'s reading (the share of
the traced sub-window in which no operation ran on the card), in %.  Moves
``served_tokens_per_s``."""
from yardstick.cell import BENCH, load_module

read = load_module(BENCH / "metrics" / "idle_pct.sat.py",
                   "perfbench_metric_idle_pct_sat").read
