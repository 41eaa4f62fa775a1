"""Trainer backward (``engine/training.py`` ``Trainer.loss_and_grads``:
autograd through the UNet with its remat): the device's idle seconds while
the host is inside the system's ``train.backward`` spans, per optimizer step
traced."""

from benchmark import program


def read(rec):
    idle = program.idle_in(rec, ("train.backward",))
    return idle / rec["units"] if idle is not None and rec["units"] else None
