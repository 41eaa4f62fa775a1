"""Times ``weight_grad`` (``vk_wgrad``) at the phase-1 shapes on the device
alone (``chip_smoke.device_ms``: the stream held while the host queues the
launches): dW without the bias gradient, and at the shapes of a layer with a
bias, dW with it, beside the library calls on the same inputs (``torch.mm``
in bf16, and ``torch.sum`` in fp32 for db). A tree whose ``weight_grad``
takes ``want_db`` times its one launch; a tree with ``column_sum`` times
``weight_grad`` then ``column_sum``, and ``column_sum`` alone; a tree with
``sum_splits`` (the split sum as a launch of its own) times it alone on the
plan's partials, beside ``part.sum(0)``, with its byte bound. Also prints a
hash of dW's bits at each shape (fp32 and bf16 results, inputs from a fixed
seed), so that two trees' runs show whether dW kept its bits. Then the two
callers at ds1 (576x1024) on the device alone: ``ln_linear_split_bwd``
(qkv_bwd, every gradient) and ``linear_residual_bwd`` (K3's backward). Runs through
the public API of the tree it is run from (its working directory). Prints
one line, ``ALONE_WGRAD {json}``: each key a time in ms, with the byte
bound beside it.

    cd <tree> && python3 <path>/tools/torch_wgrad_alone.py
"""

import hashlib
import inspect
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vista_tpu_torch.ops import linear  # noqa: E402

# (M, segs, N1, N2, the layer has a bias, use): the phase-1 step's products
SHAPES = [(230400, 1, 320, 320, True, "K3 attn-out ds1"),
          (230400, 3, 320, 320, False, "qkv ds1"),
          (230400, 1, 2560, 320, True, "ff_bwd dW1 ds1"),
          (230400, 1, 320, 1280, True, "ff_bwd dW2 ds1"),
          (57600, 3, 640, 640, False, "qkv ds2"),
          (14400, 3, 1280, 1280, False, "qkv ds4"),
          (14400, 1, 1280, 1280, True, "K3 temporal-out ds4")]


def bits(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main():
    cs.card_check()
    gen = torch.Generator(device="cuda").manual_seed(0)
    weight_grad = linear.weight_grad
    in_launch = "want_db" in inspect.signature(weight_grad).parameters
    column_sum = getattr(linear, "column_sum", None)
    sum_splits = getattr(linear, "sum_splits", None)
    out = {"card": cs.CARD, "db": "in the launch" if in_launch else "column_sum"}
    for m, segs, n1, n2, bias, use in SHAPES:
        a = torch.randn(*((segs,) if segs > 1 else ()), m, n1, generator=gen,
                        device="cuda").bfloat16()
        b = torch.randn(m, n2, generator=gen, device="cuda").bfloat16()
        flat = a.permute(1, 0, 2).reshape(m, segs * n1) if segs > 1 else a
        key = f"{use} ({m}; {segs}x{n1} x {n2})"
        nbytes = 2 * m * (segs * n1 + n2) + 4 * segs * n1 * n2
        out[f"{key} bound"] = cs.bound(2 * m * segs * n1 * n2, nbytes)[0]
        out[f"{key} dW"] = cs.device_ms(lambda: weight_grad(a, b))
        out[f"{key} library mm"] = cs.device_ms(lambda: torch.mm(flat.t(), b))
        out[f"{key} dW bits fp32"] = bits(weight_grad(a, b))
        out[f"{key} dW bits bf16"] = bits(weight_grad(a, b, torch.bfloat16))
        if sum_splits is not None:
            splits = linear.wgrad_plan(m, n1, n2, segs, torch.cuda.get_device_properties(
                0).multi_processor_count)[1]
            # its own generator: the inputs of the next shapes stay those of a tree without it
            part = torch.randn(splits, segs * n1, n2, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))
            out[f"{key} sum_splits ({splits} splits)"] = cs.device_ms(
                lambda: sum_splits(part, splits, (segs * n1, n2)))
            out[f"{key} sum_splits library part.sum(0)"] = cs.device_ms(lambda: part.sum(0))
            out[f"{key} sum_splits bound"] = 4 * (splits + 1) * segs * n1 * n2 / cs.PEAK_BYTES * 1e3
            del part
        if bias:
            if in_launch:
                out[f"{key} dW + db"] = cs.device_ms(lambda: weight_grad(a, b, want_db=True))
            else:
                out[f"{key} dW + db"] = cs.device_ms(lambda: (weight_grad(a, b), column_sum(a)))
                out[f"{key} column_sum"] = cs.device_ms(lambda: column_sum(a))
            out[f"{key} library mm + sum"] = cs.device_ms(
                lambda: (torch.mm(flat.t(), b), torch.sum(a, 0, dtype=torch.float32)))
            out[f"{key} library sum"] = cs.device_ms(lambda: torch.sum(a, 0, dtype=torch.float32))
            out[f"{key} sum bound"] = 2 * m * n1 / cs.PEAK_BYTES * 1e3
        del a, b, flat
        torch.cuda.empty_cache()
    m, c = 230400, 320
    x, g, w = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
               for shape in ((m, c), (3, m, c), (3 * c, c)))
    lw, lb = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    out["qkv_bwd ds1 (230400, 320)->3x320"] = cs.device_ms(
        lambda: linear.ln_linear_split_bwd(x, lw, lb, w, g))
    out["K3 backward attn-out ds1 (230400, 320)"] = cs.device_ms(
        lambda: linear.linear_residual_bwd(x, w[:c], g[0]))
    print("ALONE_WGRAD " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
