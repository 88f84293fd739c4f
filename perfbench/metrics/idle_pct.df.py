"""Device, dataframe cells: the share of the traced sub-window in which no
operation ran on the card (one minus the union of the device intervals over
its length), in %.  Moves ``rows_per_s``."""
from yardstick.readings import idle_pct


def read(ctx):
    return idle_pct(ctx)
