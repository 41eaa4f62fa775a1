#!/bin/bash
# A/B of two trees of the PyTorch port on one card, in turns: parent,
# change, change, parent. Each run is the tree's own `chip_smoke.py
# --profile`, then tools/torch_ff_bwd_dh_alone.py, tools/torch_attention_alone.py,
# tools/torch_k4_alone.py, tools/torch_ln_alone.py and tools/torch_wgrad_alone.py
# in the same tree;
# after the four runs, the change's card tests and a comparison of the SASS
# of every kernel that the two libraries share by name (a kernel in one tree
# only is listed as such).
#
# Unpack both trees into a gitignored directory first, e.g.
#   git archive <parent commit> | tar -x -C build/ab/parent
#   git archive $(git write-tree) | tar -x -C build/ab/change
# then, from the root of the checkout on the card's machine:
#   bash tools/torch_chip_ab.sh build/ab/parent build/ab/change
# Logs and each run's tables go to ab/ in chip_smoke.py's output directory
# (chip_smoke.OUT). With a third argument `train` (or `phase1`), it runs only
# the phase-2 step (chip_smoke.train_run; or the phase-1 micro-steps,
# chip_smoke.phase1_run), eight times, the two trees alternating, for a
# host-bound metric whose spread needs more runs; logs go to ab_train/ (or
# ab_phase1/).
set -u
PARENT=$1
CHANGE=$2
MODE=${3:-}
HERE=$PWD
RESULTS=$(python3 -c "import chip_smoke; print(chip_smoke.OUT)")
OUT=$HERE/$RESULTS/ab
[ -n "$MODE" ] && OUT=$HERE/$RESULTS/ab_$MODE
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
if [ "$MODE" = train ] || [ "$MODE" = phase1 ]; then
  run=train_run lines="train: |profile train_step|rc="
  [ "$MODE" = phase1 ] && run=phase1_run lines="phase 1 at|profile phase1|rc="
  for i in 1 2 3 4 5 6 7 8; do
    side=parent dir=$PARENT
    [ $((i % 2)) = 0 ] && side=change dir=$CHANGE
    log="$OUT/run${i}_${side}.txt"
    (cd "$dir" && timeout -k 10 300 python3 -c \
       "import chip_smoke as cs; cs.card_check(); cs.build(); cs.$run(0, True)" > "$log" 2>&1
     echo "rc=$?" >> "$log")
    echo "== run $i $side"
    grep -E "$lines" "$log"
  done
  exit 0
fi
i=0
for side in parent change change parent; do
  i=$((i + 1))
  dir=$PARENT
  [ "$side" = change ] && dir=$CHANGE
  log="$OUT/run${i}_${side}.txt"
  (cd "$dir" && timeout -k 10 1150 python3 chip_smoke.py --profile > "$log" 2>&1
   echo "rc=$?" >> "$log"
   timeout -k 10 120 python3 "$HERE/tools/torch_ff_bwd_dh_alone.py" >> "$log" 2>&1
   timeout -k 10 120 python3 "$HERE/tools/torch_attention_alone.py" >> "$log" 2>&1
   timeout -k 10 120 python3 "$HERE/tools/torch_k4_alone.py" >> "$log" 2>&1
   timeout -k 10 120 python3 "$HERE/tools/torch_ln_alone.py" >> "$log" 2>&1
   timeout -k 10 180 python3 "$HERE/tools/torch_wgrad_alone.py" >> "$log" 2>&1)
  rm -rf "$OUT/run${i}_${side}_out"
  mv "$dir/$RESULTS" "$OUT/run${i}_${side}_out" 2>/dev/null
  echo "== run $i $side"
  grep -E "^phase |request 2|rollout round|  rollout: |  reward: |phase 1 at|train: |rc=|ALONE" "$log"
done
(cd "$CHANGE" && timeout 300 python3 -m pytest tests/test_torch_cuda.py -q --noconftest \
   -p no:cacheprovider 2>&1 | tail -3) | tee "$OUT/card_tests.txt"
python3 - "$PARENT"/build/libvista_kernels-*.so "$CHANGE"/build/libvista_kernels-*.so <<'PY' | tee "$OUT/sass_diff.txt"
import re, subprocess, sys

def kernels(so):
    dump = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so], capture_output=True,
                          text=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", dump)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = body
    return out

a, b = kernels(sys.argv[1]), kernels(sys.argv[2])
for name in sorted(set(a) | set(b)):
    same = ("only in parent" if name not in b else "only in change" if name not in a else
            "identical SASS" if a[name] == b[name] else "DIFFERENT SASS")
    print(f"{name}: {same} ({len(a.get(name, '').splitlines())} / "
          f"{len(b.get(name, '').splitlines())} lines)")
PY
