"""Kernels (``ops/*.py`` -> ``csrc/*.cu``): the share of their roofline that
the kernels counted whole by ``benchmark/counts.py`` reach, in %: the sum of
every launch's bound (from its call site's shapes) over their summed device
time. The launches the count expects at each call site have to be the ones
the system counted, else nothing sound can be read and the metric is left
out."""

from collections import Counter

from benchmark import trace

# the count's kernel names -> their groups in the trace
GROUPS = {"attention": ("K: attention (wgmma)", "K: attention (short, Sk <= 64)"),
          "ln_linear": ("K: ln_linear",), "linear_residual": ("K: linear_residual",),
          "gn_silu": ("K: gn_silu_conv3",), "gn_silu_conv3": ("K: gn_silu_conv3",),
          "conv3": ("K: conv3",),
          "attention_bwd": ("K: attention_bwd dK/dV (wgmma)", "K: attention_bwd dQ (wgmma)",
                            "K: attention_bwd prep (lse, D)", "K: attention_bwd (short, Sk <= 64)")}


def read(rec):
    expected = Counter()
    bound = 0.0
    for launch, n in rec["launches"]:
        expected[f"{launch.kernel}/{launch.site}"] += n
        bound += n * launch.seconds
    kernels = {k.split("/")[0] for k in expected}
    counted = {k: v for k, v in rec["sites"].items() if k.split("/")[0] in kernels}
    if counted != dict(expected):
        return None
    groups = trace.groups(rec["device"])
    seconds = sum(groups.get(g, 0.0) for g in {g for k in kernels for g in GROUPS[k]})
    return 100.0 * bound / seconds if seconds else None
