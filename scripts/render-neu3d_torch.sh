#!/bin/bash
# scripts/render-neu3d.sh through the PyTorch port, on the GPU unless a
# trailing --device says otherwise:
#   render-neu3d_torch.sh <scene_path> <expname> [iteration] [--device <dev>]
set -e
DEVICE=()
if [ $# -ge 2 ] && [ "${*: -2:1}" = "--device" ]; then
    DEVICE=(--device "${*: -1}")
    set -- "${@:1:$#-2}"
fi
SCENE_PATH=${1:?usage: render-neu3d_torch.sh <scene_path> <expname> [iteration] [--device <dev>]}
EXPNAME=${2:?}
ITER=${3:--1}
for LEVEL in 1 2 3; do
  python -m langsplat4d_torch.render --model_path "output/${EXPNAME}_${LEVEL}" \
      --source_path "$SCENE_PATH" --feature_level "$LEVEL" \
      --configs configs/neu3d/default.py \
      --mode lang --load_stage fine-lang --iteration "$ITER" --skip_train --skip_video \
      "${DEVICE[@]}"
done
