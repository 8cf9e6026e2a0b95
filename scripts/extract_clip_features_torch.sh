#!/bin/bash
# CLIP segment features from cached DEVA mask stacks through the PyTorch
# port, on the GPU unless --device says otherwise:
#   extract_clip_features_torch.sh <scene_path> <mask_dir> \
#       --model_path <local CLIP ViT-B/16 checkpoint> [--device cuda]
# Frames are <scene_path>/rgb/2x/*.png; features go to
# <scene_path>/language_features. Without --model_path it stops, naming the
# model: nothing is downloaded.
set -e
SCENE=${1:?usage: extract_clip_features_torch.sh <scene_path> <mask_dir> --model_path <dir> [--device <dev>]}
MASKS=${2:?}
shift 2
python -m langsplat4d_torch.preprocess.clip_features --scene_path "$SCENE" \
    --mask_dir "$MASKS" "$@"
