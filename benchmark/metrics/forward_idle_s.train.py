"""Trainer forward (``engine/training.py`` ``_loss``: the first stage, the
conditioner, the UNet's forward): the device's idle seconds while the host
is inside the system's ``train.forward`` spans, per optimizer step traced."""

from benchmark import program


def read(rec):
    idle = program.idle_in(rec, ("train.forward",))
    return idle / rec["units"] if idle is not None and rec["units"] else None
