"""Times K4 (``gn_silu_conv3``, both epilogues) at its four sites of the
576x1024 request and the mid site of 320x576, and ``conv3`` (dx of K4's
backward) at its phase-2 and phase-1 ds1 shapes, through the public API of
the tree it is run from (its working directory), on one card: CUDA events,
mean of 10 calls after a warm-up (``chip_smoke.time_ms``) and the device
time alone (``chip_smoke.device_ms``: the stream held while the host queues
the launches, for the sites shorter than a launch from Python). Prints one
line, ``ALONE_K4 {json}``.

    cd <tree> && python3 <path>/tools/torch_k4_alone.py
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vista_tpu_torch.ops.temporal_conv import _flipped_taps, conv3, gn_silu_conv3  # noqa: E402

K4_SITES = [(50, 9216, 320, "ds1"), (50, 2304, 640, "ds2"), (50, 576, 1280, "ds4"),
            (50, 144, 1280, "mid"), (50, 45, 1280, "mid 320x576")]
CONV3_SITES = [(25, 2880, 320, "ds1 320x576"), (25, 720, 640, "ds2 320x576"),
               (25, 9216, 320, "ds1 576x1024")]


def main():
    cs.card_check()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    out = {"card": cs.CARD}

    def timed(key, fn):
        out[key] = cs.time_ms(fn, 10)
        out[f"{key} device"] = cs.device_ms(fn)

    for bt, s, c, tag in K4_SITES:
        x = rnd(bt, s, c)
        sc, sh = rnd(bt, c, std=0.5, dtype=torch.float32), rnd(bt, c, std=0.5, dtype=torch.float32)
        w, b = rnd(c, c, 3, 1, 1, std=(3 * c) ** -0.5), rnd(c, std=0.1, dtype=torch.float32)
        emb, rs = rnd(bt, c, dtype=torch.float32), torch.full((1,), 0.4, device="cuda")
        timed(f"emb {tag} ({bt},{s},{c})", lambda: gn_silu_conv3(x, sc, sh, w, b, 25, emb=emb))
        timed(f"res {tag} ({bt},{s},{c})",
              lambda: gn_silu_conv3(x, sc, sh, w, b, 25, residual=x, res_scale=rs))
        del x
    for bt, s, c, tag in CONV3_SITES:
        gy = rnd(bt, s, c)
        wt = _flipped_taps(rnd(c, c, 3, 1, 1, std=(3 * c) ** -0.5))
        timed(f"conv3 dx {tag} ({bt},{s},{c})", lambda: conv3(gy, wt, None, 25))
        del gy
    torch.cuda.empty_cache()
    print("ALONE_K4 " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
