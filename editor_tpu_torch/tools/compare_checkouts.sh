#!/usr/bin/env bash
# Hold this checkout's shipped kernels (K1-K8) and the variants T1, T2, T6 and
# T3 against another checkout's on one card: the output digests and ms of
# kernel_digest.py in the order other,
# this, this, other (so a drift of the card's clock shows as a difference
# between the two runs of one side), then the registers, spills and SASS
# instruction mix of each named source in both checkouts (kernel_sass.py).
# K1's output and probs, K3's output and K4's dqkv at each of their shapes,
# K5's dqkv at its two, K6's output at its two model shapes and K7's dqkv at
# its three shapes, T1's output and probs, T2's output, T6's output and
# dqkv at its two shapes and T3's output and probs of the two sides are
# compared element by element (kernel_digest.py --diff into diff.json; the
# tensors go to a temporary directory). Name attention_qkv.cu for K1's
# instances (attention_fwd_mma_kernel<FwdForm::kQkv, ...>),
# attention_variants.cu for T2's and T1's (<kNoMax, ...> and <kSplit, ...>),
# masked_attention.cu for K3's and K6's (<kFull, ...> and <kTiled, ...>, and
# the same forms of attention_fwd_mma_walk_kernel: T6's forward and K6's
# group sweep), attention_qkv_bwd.cu and masked_attention_bwd.cu for K4's,
# K7's and K5's (and attention_bwd_mma_walk_kernel<kFull, ...>, T6's
# backward): one JSON line each, with its registers, spills and HMMA count; a source one checkout
# lacks is read in the other only.
#
#   bash editor_tpu_torch/tools/compare_checkouts.sh <other checkout> <out dir> [source.cu ...]
#
# Run from the root of this checkout. Writes digest_<i>_<other|this>.txt,
# diff.json and sass_<other|this>_<source>.jsonl into <out dir>. Both
# checkouts build their kernels into their own editor_tpu_torch/_build/.
set -euo pipefail
other=$(cd "$1" && pwd)
out=$2
shift 2
here=$(pwd)
mkdir -p "$out"
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
i=0
for who in other this this other; do
  i=$((i + 1))
  dir=$here
  [ "$who" = other ] && dir=$other
  PYTHONPATH="$dir" python3 "$here/editor_tpu_torch/tools/kernel_digest.py" \
    --save "$tmp/saved_${who}.pt" > "$out/digest_${i}_${who}.txt"
done
PYTHONPATH="$here" python3 "$here/editor_tpu_torch/tools/kernel_digest.py" \
  --diff "$tmp/saved_other.pt" "$tmp/saved_this.pt" > "$out/diff.json"
for src in "$@"; do
  for who in other this; do
    dir=$here
    [ "$who" = other ] && dir=$other
    [ -f "$dir/editor_tpu_torch/csrc/$src" ] || continue
    python3 -m editor_tpu_torch.tools.kernel_sass "$dir/editor_tpu_torch/csrc/$src" \
      > "$out/sass_${who}_${src%.cu}.jsonl"
  done
done
