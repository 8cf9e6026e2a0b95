#!/bin/bash
# scripts/eval-hypernerf.sh through the PyTorch port: open-vocabulary
# localization eval, on the GPU unless a trailing --device says otherwise:
#   eval-hypernerf_torch.sh <expname> <iterations> <annotation_folder> <ae_ckpt> [--device <dev>]
set -e
DEVICE=()
if [ $# -ge 2 ] && [ "${*: -2:1}" = "--device" ]; then
    DEVICE=(--device "${*: -1}")
    set -- "${@:1:$#-2}"
fi
EXPNAME=${1:?usage: eval-hypernerf_torch.sh <expname> <iterations> <annotation_folder> <ae_ckpt> [--device <dev>]}
ITER=${2:?}
ANNOT=${3:?}
AE=${4:?}
python -m langsplat4d_torch.eval --exp_name "$EXPNAME" --iterations "$ITER" \
    --annotation_folder "$ANNOT" --ae_ckpt_path "$AE" \
    --dataset_type hypernerf --detail_results "${DEVICE[@]}"
