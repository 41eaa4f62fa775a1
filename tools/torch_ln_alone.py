"""Times the LayerNorm pair at the phase-1 shapes (576x1024: ds1, ds2 and
ds4 rows) on the device alone (``chip_smoke.device_ms``: the stream held
while the host queues the launches), beside their library calls on the same
inputs: ``layer_norm`` against ``F.layer_norm``, and ``ln_backward`` in
qkv_bwd's form (fp32 dxn, fp32 γ, dγ/dβ) and ff_bwd's (fp32 dxn and the
residual's cotangent, bf16 γ, dγ/dβ) against ``native_layer_norm_backward``
on bf16 x and dy, and qkv_bwd's form without dγ/dβ (the cost of their
in-launch fold is the difference); then the LoRA norm1's form (bf16 dy,
frozen γ) at the phase-2 ds1 shape. Runs through the public API of the tree
it is run from (its working directory); a tree whose ``ln_backward`` still
lives in ``ops/linear.py`` and takes only fp32 dxn gets no LoRA-form time.
Prints one line, ``ALONE_LN {json}``: each key a time in ms, with the byte
bound beside it.

    cd <tree> && python3 <path>/tools/torch_ln_alone.py
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vista_tpu_torch.ops.norms import layer_norm_kernel  # noqa: E402

try:
    from vista_tpu_torch.ops.norms import ln_backward  # noqa: E402
    BF16_DXN = True
except ImportError:  # the LN backward before it moved beside the forward
    from vista_tpu_torch.ops.linear import ln_backward  # noqa: E402
    BF16_DXN = False

SHAPES = [(230400, 320, "ds1"), (57600, 640, "ds2"), (14400, 1280, "ds4")]


def main():
    cs.card_check()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    out = {"card": cs.CARD}

    def timed(key, kernel, library, nbytes):
        out[key] = cs.device_ms(kernel)
        out[f"{key} library"] = cs.device_ms(library)
        out[f"{key} bound"] = nbytes / cs.PEAK_BYTES * 1e3

    def backward_forms(m, c, tag, forms):
        x, lwb, lbb = rnd(m, c, std=2.0), rnd(c, std=0.1) + 1, rnd(c, std=0.1)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], lwb, lbb, 1e-5)
        for form, dxn_dtype, with_res, want in forms:
            dxn = rnd(m, c, dtype=dxn_dtype)
            dres = rnd(m, c) if with_res else None
            lw = lwb.float() if form.startswith("qkv") else lwb
            dy = dxn.to(bf)
            timed(f"ln_bwd {form} {tag} ({m},{c})",
                  lambda: ln_backward(x, dxn, lw, dres, 1e-5, want),
                  lambda: torch.ops.aten.native_layer_norm_backward(
                      dy, x, [c], mean, rstd, lwb, lbb, [True, want, want]),
                  m * c * (2 + dxn.element_size() + 2 * with_res + 2))
            del dxn, dres, dy

    for m, c, tag in SHAPES:
        x, lw, lb = rnd(m, c, std=2.0), rnd(c, std=0.1) + 1, rnd(c, std=0.1)
        timed(f"layer_norm {tag} ({m},{c})", lambda: layer_norm_kernel(x, lw, lb),
              lambda: F.layer_norm(x, (c,), lw, lb), 4 * m * c)
        del x
        backward_forms(m, c, tag, [("qkv", torch.float32, False, True),
                                   ("qkv without dγ/dβ", torch.float32, False, False),
                                   ("ff", torch.float32, True, True)])
    if BF16_DXN:
        backward_forms(72000, 320, "ds1 320x576", [("lora", bf, False, False)])
    torch.cuda.empty_cache()
    print("ALONE_LN " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
