"""UNet glue: PyTorch's own copies, casts, elementwise kernels and
reductions between the hand-written kernels, as a share of the window's
device time in %. Shared by the ``glue_share.*`` metrics."""

from benchmark import trace


def read(rec):
    groups = trace.groups(rec["device"])
    total = sum(groups.values())
    return 100.0 * sum(groups.get(g, 0.0) for g in trace.GLUE) / total if total else None
