"""Trainer (``engine/training.py``): the system's ``host_sync`` spans per
optimizer step traced, each a device scalar brought to the host, which
waits for the device's queue to drain."""

from benchmark import program


def read(rec):
    n = program.count(rec, "host_sync")
    return n / rec["units"] if n is not None and rec["units"] else None
