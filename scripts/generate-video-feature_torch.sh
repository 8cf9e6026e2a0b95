#!/bin/bash
# Video (temporal) language features through the PyTorch port: prompt
# frames -> captions -> E5 embeddings, on the GPU unless --device says
# otherwise:
#   generate-video-feature_torch.sh <mask_dir> <image_dir> <work_dir> \
#       --captioner_path <local Qwen2-VL-7B-Instruct> \
#       --embedder_path <local e5-mistral-7b-instruct> [--device cuda]
# The port writes the prompt frames and no mp4s (the captioner reads the
# frame directories). Without a model path the stage that needs it stops,
# naming the model: nothing is downloaded.
set -e
MASKS=${1:?usage: generate-video-feature_torch.sh <mask_dir> <image_dir> <work_dir> --captioner_path <dir> --embedder_path <dir> [--device <dev>]}
IMAGES=${2:?}
WORK=${3:?}
shift 3
DEVICE=() CAPTIONER=() EMBEDDER=()
while [ $# -gt 0 ]; do
    case "$1" in
        --device) DEVICE=(--device "$2"); shift 2 ;;
        --captioner_path) CAPTIONER=(--model_path "$2"); shift 2 ;;
        --embedder_path) EMBEDDER=(--model_path "$2"); shift 2 ;;
        *) echo "unknown argument $1" >&2; exit 2 ;;
    esac
done
python -m langsplat4d_torch.preprocess.image_prompt --mask_dir "$MASKS" \
    --image_dir "$IMAGES" --output_dir "$WORK/prompt_images" "${DEVICE[@]}"
python -m langsplat4d_torch.preprocess.video_captions \
    --prompt_image_dir "$WORK/prompt_images" --output_dir "$WORK/captions" \
    "${CAPTIONER[@]}" "${DEVICE[@]}"
python -m langsplat4d_torch.preprocess.video_features \
    --caption_dir "$WORK/captions" --segmentation_dir "$MASKS" \
    "${EMBEDDER[@]}" "${DEVICE[@]}"
