"""Optimizer (``engine/training.py`` ``Trainer.apply``): device seconds of
the operations launched inside the system's ``train.apply`` spans (its fp32
passes), per optimizer step traced."""

from benchmark import program


def read(rec):
    busy = program.busy_in(rec, ("train.apply",))
    return busy / rec["units"] if busy is not None and rec["units"] else None
