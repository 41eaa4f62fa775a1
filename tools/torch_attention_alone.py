"""Times K1 (``attention_forward``, no LSE: the sampling path) alone at the
full sampling shapes, 50 frames of the doubled batch at 576x1024, in the
tree it is run from (its working directory), on one card, beside one
``scaled_dot_product_attention`` call on the same inputs: CUDA events, mean
of 10 launches after a warm-up (``chip_smoke.time_ms``). The plain version
does not fit at these shapes (its fp32 scores at ds1 would take 68 GB); the
kernel's agreement with it is ``chip_smoke.py``'s kernels phase. Prints
one line, ``ALONE_K1 {json}``.

    cd <tree> && python3 <path>/tools/torch_attention_alone.py
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vista_tpu_torch.ops.attention import attention_forward  # noqa: E402

# (batch rows, tokens, heads): the spatial sites ds1, ds2, ds4 and mid of
# 576x1024 over 50 frames, and the temporal t = 25 attention of ds1
SHAPES = [(50, 9216, 5, "ds1"), (50, 2304, 10, "ds2"), (50, 576, 20, "ds4"),
          (50, 144, 20, "mid"), (18432, 25, 5, "temporal ds1")]


def main():
    cs.card_check()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": cs.CARD}
    for b, s, h, tag in SHAPES:
        q, k, v = (torch.randn(b, s, h * 64, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        q4, k4, v4 = (cs.sdpa_layout(t, h) for t in (q, k, v))
        key = f"{tag} ({b},{s},{h}x64)"
        out[key] = cs.time_ms(lambda: attention_forward(q, k, v, h), 10)
        out[f"{key} sdpa"] = cs.time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 10)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    print("ALONE_K1 " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
