"""Optimizer (``engine/training.py`` ``Trainer.apply``: accumulation, clip,
Adam, schedule, EMA): host wall inside the ``apply`` spans per optimizer
step traced, in s: the time the host takes to issue the update (its
launches and whatever it waits for), which the device's queue hides only
in part."""


def read(rec):
    spans = [e - s for n, s, e in rec["spans"] if n == "apply"]
    return sum(spans) / rec["units"] if spans and rec["units"] else None
