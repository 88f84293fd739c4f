"""Device, rag_sat: the share of the traced sub-window in which no
operation ran on the card (one minus the union of the device intervals,
which prefill and decode issue from two threads), in %.  Moves
``served_tokens_per_s``."""
from yardstick.readings import idle_pct


def read(ctx):
    return idle_pct(ctx)
