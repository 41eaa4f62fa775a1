"""Times K1 (``attention_forward``, no LSE: the sampling path) alone at the
full sampling shapes, 50 frames of the doubled batch at 576x1024, beside one
``scaled_dot_product_attention`` call on the same inputs, and the attention
backward (``attention_bwd`` from K1's LSE) at the temporal t = 25 shapes of
both training paths, in the tree it is run from (its working directory), on
one card. CUDA events, mean of 10 launches after a warm-up
(``chip_smoke.time_ms``); the temporal shapes, whose kernels are shorter
than a launch from Python, also on the device alone (``chip_smoke.device_ms``:
the stream held while the host queues the launches), under the key
``"... device"``. The plain version does not fit at the spatial shapes (its
fp32 scores at ds1 would take 68 GB); the kernels' agreement with it is
``chip_smoke.py``'s kernels phase. Prints one line, ``ALONE_K1 {json}``.

    cd <tree> && python3 <path>/tools/torch_attention_alone.py
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vista_tpu_torch.ops.attention import attention_bwd, attention_forward  # noqa: E402

# (batch rows, tokens, heads): the spatial sites ds1, ds2, ds4 and mid of
# 576x1024 over 50 frames, and the temporal t = 25 attention of ds1, ds2
# and ds4 (2 h w rows)
SHAPES = [(50, 9216, 5, "ds1"), (50, 2304, 10, "ds2"), (50, 576, 20, "ds4"),
          (50, 144, 20, "mid"), (18432, 25, 5, "temporal ds1"), (4608, 25, 10, "temporal ds2"),
          (1152, 25, 20, "temporal ds4")]
# the backward's temporal shapes: phase 2 (320x576) and phase 1 (576x1024),
# batch 1, h w rows
BWD_SHAPES = [(2880, 25, 5, "bwd temporal ds1 320x576"), (720, 25, 10, "bwd temporal ds2 320x576"),
              (9216, 25, 5, "bwd temporal ds1 576x1024"),
              (2304, 25, 10, "bwd temporal ds2 576x1024")]


def main():
    cs.card_check()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda b, s, h: torch.randn(b, s, h * 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {"card": cs.CARD}
    for b, s, h, tag in SHAPES:
        q, k, v = (rnd(b, s, h) for _ in range(3))
        q4, k4, v4 = (cs.sdpa_layout(t, h) for t in (q, k, v))
        key = f"{tag} ({b},{s},{h}x64)"
        out[key] = cs.time_ms(lambda: attention_forward(q, k, v, h), 10)
        out[f"{key} sdpa"] = cs.time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 10)
        if s <= 64:
            out[f"{key} device"] = cs.device_ms(lambda: attention_forward(q, k, v, h))
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    for b, s, h, tag in BWD_SHAPES:
        q, k, v, do = (rnd(b, s, h) for _ in range(4))
        o, lse = attention_forward(q, k, v, h, want_lse=True)
        key = f"{tag} ({b},{s},{h}x64)"
        out[key] = cs.time_ms(lambda: attention_bwd(q, k, v, o, lse, do, h), 10)
        out[f"{key} device"] = cs.device_ms(lambda: attention_bwd(q, k, v, o, lse, do, h))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print("ALONE_K1 " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
