#!/bin/bash
# scripts/render-hypernerf.sh through the PyTorch port: all levels of a
# HyperNeRF experiment, on the GPU unless a trailing --device says
# otherwise:
#   render-hypernerf_torch.sh <scene_path> <expname> [iteration] [--device <dev>]
set -e
DEVICE=()
if [ $# -ge 2 ] && [ "${*: -2:1}" = "--device" ]; then
    DEVICE=(--device "${*: -1}")
    set -- "${@:1:$#-2}"
fi
SCENE_PATH=${1:?usage: render-hypernerf_torch.sh <scene_path> <expname> [iteration] [--device <dev>]}
EXPNAME=${2:?}
ITER=${3:--1}
for LEVEL in 1 2 3; do
  python -m langsplat4d_torch.render --model_path "output/${EXPNAME}_${LEVEL}" \
      --source_path "$SCENE_PATH" --feature_level "$LEVEL" \
      --mode lang --load_stage fine-lang --iteration "$ITER" --skip_train --skip_test \
      "${DEVICE[@]}"
done
