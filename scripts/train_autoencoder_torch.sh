#!/bin/bash
# scripts/train_autoencoder.sh through the PyTorch port: the CLIP (512->3)
# or video (4096->6) autoencoder, on the GPU unless a trailing --device
# says otherwise:
#   train_autoencoder_torch.sh <dataset_path> <model_name> [clip|video] [--device <dev>]
set -e
DEVICE=()
if [ $# -ge 2 ] && [ "${*: -2:1}" = "--device" ]; then
    DEVICE=(--device "${*: -1}")
    set -- "${@:1:$#-2}"
fi
DATASET=${1:?usage: train_autoencoder_torch.sh <dataset_path> <model_name> [mode=clip|video] [--device <dev>]}
NAME=${2:?}
MODE=${3:-clip}
if [ "$MODE" = "video" ]; then
  python -m langsplat4d_torch.ae.train --dataset_path "$DATASET" --model_name "$NAME" \
      --encoder_dims 2048 1024 512 256 128 64 32 6 \
      --decoder_dims 32 64 128 256 512 1024 2048 4096 \
      --feature_dims 4096 --hidden_dims 6 --language_name video_features \
      "${DEVICE[@]}"
  python -m langsplat4d_torch.ae.test --dataset_path "$DATASET" --model_name "$NAME" \
      --encoder_dims 2048 1024 512 256 128 64 32 6 \
      --decoder_dims 32 64 128 256 512 1024 2048 4096 \
      --feature_dims 4096 --hidden_dims 6 --language_name video_features \
      "${DEVICE[@]}"
else
  python -m langsplat4d_torch.ae.train --dataset_path "$DATASET" --model_name "$NAME" \
      "${DEVICE[@]}"
  python -m langsplat4d_torch.ae.test --dataset_path "$DATASET" --model_name "$NAME" \
      "${DEVICE[@]}"
fi
