"""Run chosen phases of ``chip_smoke.py`` alone on the card, each on its own:
a failure is printed and the next phase still runs. Prints first whether the
``safetensors`` package imports (the port does not need it) and the Python,
torch and CUDA versions.

    python3 tools/torch_chip_phases.py                      # the four newest phases
    python3 tools/torch_chip_phases.py sampling_modes quality

Phases: ``sampling_modes``, ``vae_train``, ``quality``, ``train_cli`` (with
``convert`` on its checkpoint), or any other ``<name>_run`` of
``chip_smoke.py`` that takes only the seed.
"""

import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
names = sys.argv[1:] or ["sampling_modes", "vae_train", "quality", "train_cli"]
sys.argv = ["chip_smoke.py"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

try:
    import safetensors
    print("safetensors importable:", safetensors.__version__, flush=True)
except Exception as e:  # noqa: BLE001
    print("safetensors not importable:", repr(e), flush=True)
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
cs.phase("card", cs.card_check)
cs.phase("build", cs.build)
for name in names:
    t0 = time.perf_counter()
    try:
        if name == "train_cli":
            cs.phase(name, cs.train_cli_run, 0, cs.convert_run)
        else:
            cs.phase(name, getattr(cs, f"{name}_run"), 0)
        print(f"PHASE OK {name}", flush=True)
    except BaseException as e:  # noqa: BLE001
        traceback.print_exc()
        print(f"PHASE FAILED {name} after {time.perf_counter() - t0:.1f} s: {e!r}", flush=True)
    torch.cuda.empty_cache()
