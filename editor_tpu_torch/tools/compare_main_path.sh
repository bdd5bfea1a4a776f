#!/usr/bin/env bash
# Time the flagship's main path in several checkouts on one card: the eval
# forward at B = 128 and B = 1 (profile_forward) and the train step at
# B = 128 (profile_train), each checkout run from its own root with its
# kernels built into its own editor_tpu_torch/_build/. The checkouts run in
# the order given and then in reverse (a b c c b a), so a drift of the
# card's clock shows as a difference between the two runs of one side.
#
#   bash editor_tpu_torch/tools/compare_main_path.sh <out dir> <checkout> [<checkout> ...]
#
# Writes forward_<i>_<name>.txt and train_<i>_<name>.txt (the tools' stdout:
# the card, the ms per call, img/s, peak memory and idle share) and the
# per-kernel tables forward_kernels_<i>_<name>.txt and
# train_kernels_<i>_<name>.txt into <out dir>; <name> is the checkout's
# directory name and <i> the run's place in the order.
set -euo pipefail
mkdir -p "$1"
out=$(cd "$1" && pwd)
shift
dirs=()
for d in "$@"; do dirs+=("$(cd "$d" && pwd)"); done
order=("${dirs[@]}")
for ((j = ${#dirs[@]} - 1; j >= 0; j--)); do order+=("${dirs[j]}"); done
i=0
for dir in "${order[@]}"; do
  i=$((i + 1))
  name=$(basename "$dir")
  (cd "$dir" && PYTHONPATH="$dir" python3 -m editor_tpu_torch.tools.profile_forward \
    --batch 128 1 --out "$out/forward_kernels_${i}_${name}.txt") > "$out/forward_${i}_${name}.txt"
  (cd "$dir" && PYTHONPATH="$dir" python3 -m editor_tpu_torch.tools.profile_train \
    --out "$out/train_kernels_${i}_${name}.txt") > "$out/train_${i}_${name}.txt"
done
