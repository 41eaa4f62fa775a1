"""Device (one H100): the share of the traced window's wall in which no
operation ran on the card (one minus the union of the device intervals),
in %. Shared by the ``idle_share.*`` metrics."""

from benchmark import trace


def read(rec):
    wall = trace.window_s(rec)
    return 100.0 * (1.0 - trace.busy_s(rec) / wall) if wall > 0 else None
