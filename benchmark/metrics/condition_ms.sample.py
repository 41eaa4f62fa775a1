"""Conditioning (``models/conditioner.py``, ``clip.py``, ``vae.py``
``VAEEncoder``, through ``engine.encode_first_stage`` and
``engine.conditions``): device milliseconds launched inside the system's
``encode`` and ``condition`` spans plus the device's idle time while the
host is inside them, per request traced."""

from benchmark import program

NAMES = ("encode", "condition")


def read(rec):
    busy, idle = program.busy_in(rec, NAMES), program.idle_in(rec, NAMES)
    return 1e3 * (busy + idle) / rec["units"] if busy is not None and rec["units"] else None
