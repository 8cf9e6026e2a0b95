#!/bin/bash
# scripts/train_eval.sh through the PyTorch port, on the GPU unless a
# trailing --device says otherwise:
#   train_eval_torch.sh <scene_path> <expname> [lang_dim] [--device <dev>]
# The same two phases, flags and environment as train_eval.sh. Phase B
# resumes output/<expname>/chkpnt_fine-base_10000.pth, which the port reads
# in its own layout or in the JAX package's.
set -e
DEVICE=()
if [ $# -ge 2 ] && [ "${*: -2:1}" = "--device" ]; then
    DEVICE=(--device "${*: -1}")
    set -- "${@:1:$#-2}"
fi
SCENE_PATH=${1:?usage: train_eval_torch.sh <scene_path> <expname> [lang_dim] [--device <dev>]}
EXPNAME=${2:?}
LANG_DIM=${3:-6}
export language_feature_hiddendim=$LANG_DIM

# Phase A: geometry + static language features (no temporal language MLP),
# checkpoint at 10000 for the discrete resume.
python -m langsplat4d_torch.train --source_path "$SCENE_PATH" \
    --expname "$EXPNAME" --configs configs/hypernerf/default.py \
    --fine_lang_iterations 0 --no_dlang 0 --checkpoint_iterations 10000 \
    "${DEVICE[@]}"

# Phase B: resume into fine-lang-discrete with per-Gaussian feature centers.
use_discrete_lang_f=t python -m langsplat4d_torch.train \
    --source_path "$SCENE_PATH" \
    --expname "$EXPNAME" --configs configs/hypernerf/default.py \
    --resume_from_final_stage 1 --init_from_stage fine-base \
    --start_checkpoint "output/$EXPNAME/chkpnt_fine-base_10000.pth" \
    "${DEVICE[@]}"
