"""Object state captions via a multimodal LLM (port of
langsplat4d/preprocess/video_captions.py; reference
preprocess/generate_video_captions.py).

Per object, (1) one video-level caption over its prompt frames, then (2)
per-frame state captions conditioned on the video caption with a
+-`context`-frame window, written as `output_text_id{obj}.csv` rows of
(frame_path, video_caption, state_caption), which
video_features.encode_feature reads.

The captioner is injected. `Qwen2VLCaptioner` needs a local copy of
Qwen2-VL-7B-Instruct and raises, naming it, without one.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.data.codec import read_image
from langsplat4d_torch.preprocess import local_model
from langsplat4d_torch.preprocess.clip_features import rgb

QWEN_MODEL = "Qwen2-VL-7B-Instruct"
VIDEO_PROMPT = ("Please describe the motion of the object highlighted by the "
                "red outline in the video, focusing on its state changes "
                "over time.")
FRAME_PROMPT = ("The video shows: {video_caption}\nDescribe the current "
                "state of the highlighted object in this frame, given the "
                "surrounding frames as context.")


class Qwen2VLCaptioner:
    """Qwen2-VL-7B-Instruct captioner from a local copy of the checkpoint;
    frames are read through the port's codec."""

    def __init__(self, model_path=None, device=None):
        transformers = local_model(model_path, QWEN_MODEL, "transformers")
        self.device = resolve_device(device)
        self.model = transformers.Qwen2VLForConditionalGeneration \
            .from_pretrained(model_path, local_files_only=True) \
            .to(self.device).eval()
        self.processor = transformers.AutoProcessor.from_pretrained(
            model_path, local_files_only=True)

    def caption_video(self, frame_paths: List[str], prompt: str) -> str:
        video = np.stack([rgb(torch.from_numpy(read_image(p))).numpy()
                          for p in frame_paths])
        messages = [{"role": "user", "content": [
            {"type": "video", "video": frame_paths},
            {"type": "text", "text": prompt}]}]
        text = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = self.processor(text=[text], videos=[video],
                                return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=256)
        return self.processor.batch_decode(
            out[:, inputs["input_ids"].shape[1]:],
            skip_special_tokens=True)[0]

    def caption_frames(self, frame_paths: List[str], prompt: str) -> str:
        return self.caption_video(frame_paths, prompt)


def generate_captions(prompt_image_dir: str, output_dir: str,
                      captioner, context: int = 3,
                      object_ids: Optional[List[int]] = None) -> None:
    """Caption every object directory under prompt_image_dir."""
    os.makedirs(output_dir, exist_ok=True)
    if object_ids is None:
        object_ids = sorted(
            int(d) for d in os.listdir(prompt_image_dir)
            if os.path.isdir(os.path.join(prompt_image_dir, d)))
    for obj_id in object_ids:
        obj_dir = os.path.join(prompt_image_dir, f"{obj_id:02}")
        frames = sorted(os.listdir(obj_dir))
        frame_paths = [os.path.join(obj_dir, f) for f in frames]
        video_caption = captioner.caption_video(frame_paths, VIDEO_PROMPT)
        out_path = os.path.join(output_dir, f"output_text_id{obj_id}.csv")
        with open(out_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["frame", "video_caption", "state_caption"])
            for i, fp in enumerate(frame_paths):
                lo = max(0, i - context)
                hi = min(len(frame_paths), i + context + 1)
                state = captioner.caption_frames(
                    frame_paths[lo:hi],
                    FRAME_PROMPT.format(video_caption=video_caption))
                writer.writerow([fp, video_caption, state])


def main(argv=None):
    p = argparse.ArgumentParser(description="Per-object state captions")
    p.add_argument("--prompt_image_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--context", type=int, default=3)
    p.add_argument("--model_path", type=str, default=None,
                   help=f"a local copy of {QWEN_MODEL} (required)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    args = p.parse_args(argv)
    generate_captions(args.prompt_image_dir, args.output_dir,
                      Qwen2VLCaptioner(args.model_path, args.device),
                      args.context)


if __name__ == "__main__":
    main()
