"""Times ff_bwd_dh alone at the phase-1 and phase-2 widths, and K3 at the
temporal out-projection, in the tree it is run from (its working
directory), on one card: CUDA events, mean of 10 launches after a warm-up
(``chip_smoke.time_ms``). Trees older than the K-major ``ff_bwd_dh`` launch
``vk_ff_bwd_dh`` with a transposed copy of W2 made per call, as their
``ff_bwd`` did. Prints one line, ``ALONE {json}``.

    cd <tree> && python3 <path>/tools/torch_ff_bwd_dh_alone.py
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vista_tpu_torch.ops import _build, fused_ff  # noqa: E402
from vista_tpu_torch.ops.linear import linear_residual  # noqa: E402


def main():
    cs.card_check()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    k_major = hasattr(fused_ff, "ff_bwd_dh")
    out = {"tree": "K-major ff_bwd_dh" if k_major else "W2^T ff_bwd_dh", "card": cs.CARD}
    for m, c in [(230400, 320), (57600, 640), (14400, 1280), (72000, 320), (4500, 1280)]:
        n = 4 * c
        xn, dy = rnd(m, c), rnd(m, c)
        w1, b1 = rnd(2 * n, c, std=c ** -0.5), rnd(2 * n, std=0.1, dtype=torch.float32)
        w2 = rnd(c, n, std=n ** -0.5)
        if k_major:
            def fn():
                fused_ff.ff_bwd_dh(xn, dy, w1, b1, w2)
        else:
            hg = torch.empty(m, n, dtype=xn.dtype, device="cuda")
            dh = torch.empty(m, 2 * n, dtype=xn.dtype, device="cuda")

            def fn():
                w2t = w2.t().contiguous()
                _build.launch("vk_ff_bwd_dh", xn.data_ptr(), dy.data_ptr(), w1.data_ptr(),
                              w2t.data_ptr(), b1.data_ptr(), hg.data_ptr(), dh.data_ptr(), m, c,
                              n)
        out[f"ff_bwd_dh ({m},{c})"] = cs.time_ms(fn, 10)
        del xn, dy
    x, o = rnd(4608, 25, 640), rnd(4608, 25, 640)
    wo, bo = rnd(640, 640, std=640 ** -0.5), rnd(640, std=0.1, dtype=torch.float32)
    out["K3 temporal out (4608,25,640)"] = cs.time_ms(lambda: linear_residual(o, wo, bo, x), 10)
    print("ALONE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
