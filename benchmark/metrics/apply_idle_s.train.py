"""Optimizer (``engine/training.py`` ``Trainer.apply``: the gradient norm,
accumulation, clip, Adam, schedule, EMA): the device's idle seconds while
the host is inside the system's ``train.apply`` spans, per optimizer step
traced."""

from benchmark import program


def read(rec):
    idle = program.idle_in(rec, ("train.apply",))
    return idle / rec["units"] if idle is not None and rec["units"] else None
