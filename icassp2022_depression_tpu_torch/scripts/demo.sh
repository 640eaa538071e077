#!/usr/bin/env bash
# End-to-end demo of the PyTorch + CUDA port on a synthetic EATD-shaped
# corpus (the real corpus is restricted-distribution): extraction, the
# fused extract-and-train path, both training tracks, the sklearn
# baselines, checking and one served prediction, each through
# `python -m icassp2022_depression_tpu_torch.cli`.  The first run on a
# card builds the CUDA kernels (kept in the package's _build/, or in
# ICASSP_TPU_TORCH_BUILD_DIR).
#
#   bash icassp2022_depression_tpu_torch/scripts/demo.sh [ROOT]
#   DEVICE=cpu bash .../demo.sh [ROOT]     # without a card
set -euo pipefail

ROOT="${1:-${TMPDIR:-/tmp}/icassp2022_torch_demo}"
PY="${PYTHON:-python}"
DEVICE="${DEVICE:-cuda}"
CLI=(-m icassp2022_depression_tpu_torch.cli)

# fresh model dir: stale artifacts from a previous run would otherwise
# mismatch the idx/checkpoint pairing below
rm -rf "$ROOT/Model"
$PY "${CLI[@]}" synth-corpus --root "$ROOT" \
    --n-data 114 --n-validation 48 --seconds 4.0 --seed 42
$PY "${CLI[@]}" extract-audio --root "$ROOT" --device "$DEVICE"
$PY "${CLI[@]}" extract-text --root "$ROOT" --device "$DEVICE"
# the fused product path: extraction -> device-resident fold data ->
# training in ONE command (features never return to the host)
$PY "${CLI[@]}" train --task audio_clf --root "$ROOT" \
    --corpus "$ROOT" --model-dir "$ROOT/Model/FusedDemo" --device "$DEVICE"
$PY "${CLI[@]}" pipeline --track clf --root "$ROOT" --device "$DEVICE"
$PY "${CLI[@]}" pipeline --track reg --root "$ROOT" --lr 3e-4 \
    --device "$DEVICE"
# the baselines run on the host with scikit-learn (a card's machine may
# have none)
if $PY -c "import sklearn" 2>/dev/null; then
  $PY "${CLI[@]}" baselines --task audio_clf --root "$ROOT"
else
  echo "baselines skipped: scikit-learn is not installed"
fi

# checking harness consumes the idx artifacts the clf training emitted
AUDIO_DIR="$ROOT/Model/ClassificationWhole/Audio"
IDX=(); CKPT=()
for f in 1 2 3; do
  c=$(ls "$AUDIO_DIR"/*_"$f".npz 2>/dev/null | grep -v train_idxs | head -1 || true)
  [ -n "$c" ] || continue
  # the emitted idx artifact shares the checkpoint's {f1:.2f}_{fold} tail
  f1=$(basename "$c" .npz | awk -F_ '{print $(NF-1)}')
  i="$AUDIO_DIR/train_idxs_${f1}_${f}.npy"
  [ -f "$i" ] && IDX+=("$i") && CKPT+=("$c")
done
if [ "${#IDX[@]}" -eq 3 ]; then
  $PY "${CLI[@]}" check --task audio_clf --root "$ROOT" \
      --ckpts "${CKPT[@]%.npz}" --idx-files "${IDX[@]}" --device "$DEVICE"
fi

# one served prediction from a trained checkpoint
if [ "${#CKPT[@]}" -ge 1 ]; then
  $PY "${CLI[@]}" predict --task audio_clf --root "$ROOT" \
      --ckpt "${CKPT[0]%.npz}" --speaker Data/1 --device "$DEVICE"
fi
echo "demo complete in ${SECONDS} s; models in $ROOT/Model, metrics JSONL alongside"
