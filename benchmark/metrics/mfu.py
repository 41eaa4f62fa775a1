"""Model step: the model FLOPs of the traced units (counted from the
configuration's shapes by ``benchmark/counts.py``) over the traced window's
wall times the card's 989 TFLOP/s dense bf16 peak, in %. Shared by the
``mfu.*`` metrics."""

from benchmark import counts, trace


def read(rec):
    wall = trace.window_s(rec)
    return 100.0 * rec["model_flops"] / (wall * counts.PEAK_FLOPS) if wall > 0 else None
