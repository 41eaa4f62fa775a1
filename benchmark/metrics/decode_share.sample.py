"""Decoder (``models/vae.py`` through ``engine.decode_first_stage``): the
share of the window's device time spent inside the decode spans, in %."""

from benchmark import trace


def read(rec):
    total = trace.device_time(rec["device"])
    ops = trace.within(rec, "decode_first_stage")
    return 100.0 * trace.device_time(ops) / total if total and ops else None
