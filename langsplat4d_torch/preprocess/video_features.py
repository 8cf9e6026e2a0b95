"""Video (temporal) language features: per-(frame, object) sentence
embeddings assembled into per-frame feature tables and shifted seg maps
(port of langsplat4d/preprocess/video_features.py; reference
preprocess/generate_video_features.py).

Caption CSVs (one per object id, rows of (frame_path, ..., state_caption))
-> per frame a float64 [max_id + 1, D] table on the device (the reference's
np.zeros dtype, so that the files match it byte for byte), rows filled from
the embedding of each state caption at the 1-based frame id parsed from the
row's path -> final `*_f.npy` (rows 1.., background dropped) and `*_s.npy`
(seg ids shifted by -1, a level axis added).

The embedder is injected. `E5SentenceEmbedder` needs a local copy of
e5-mistral-7b-instruct and raises, naming it, without one.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Callable

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.preprocess import local_model

E5_MODEL = "e5-mistral-7b-instruct"


def encode_feature(caption_dir: str, feature_name: str,
                   segmentation_dir: str, encode_text: Callable,
                   embed_dim: int = 4096, device=None) -> None:
    """Per-frame [max_id + 1, embed_dim] float64 feature tables from caption
    CSVs, written as {caption_dir}/{feature_name}/{i:06}.npy."""
    dev = resolve_device(device)
    seg_files = sorted(os.listdir(segmentation_dir))
    num_frames = len(seg_files)
    max_id = 0
    for file in seg_files:
        seg = torch.from_numpy(np.load(os.path.join(segmentation_dir, file)))
        max_id = max(max_id, int(seg.to(dev).max()))
    features = torch.zeros((num_frames, max_id + 1, embed_dim),
                           dtype=torch.float64, device=dev)

    out_dir = os.path.join(caption_dir, feature_name)
    os.makedirs(out_dir, exist_ok=True)
    caption_files = [f for f in os.listdir(caption_dir)
                     if "output_text_id" in f]
    for caption_file in caption_files:
        obj_id = int(caption_file.split("id")[1].split(".")[0])
        with open(os.path.join(caption_dir, caption_file),
                  encoding="utf-8") as f:
            reader = csv.reader(f)
            next(reader)  # header
            for row in reader:
                frame_id = int(row[0].split("/")[-1].split(".")[0])
                features[frame_id - 1, obj_id] = torch.as_tensor(
                    encode_text(row[-1]), device=dev)
    for i, feat in enumerate(features.cpu().numpy()):
        np.save(os.path.join(out_dir, f"{i + 1:06}"), feat)


def assemble_final_features(features_dir: str, segmentation_dir: str,
                            output_dir: str, device=None) -> None:
    """Shift object ids to 0-based, drop the background row, add the level
    axis."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    n = len(os.listdir(features_dir))
    if n != len(os.listdir(segmentation_dir)):
        raise ValueError(f"{n} feature tables in {features_dir} but "
                         f"{len(os.listdir(segmentation_dir))} seg maps in "
                         f"{segmentation_dir}")
    for i in range(1, n + 1):
        seg = torch.from_numpy(np.load(
            os.path.join(segmentation_dir, f"{i:06}.npy"))).to(dev)
        feat = torch.from_numpy(np.load(
            os.path.join(features_dir, f"{i:06}.npy"))).to(dev)
        np.save(os.path.join(output_dir, f"{i:06}_f.npy"),
                feat[1:].cpu().numpy())
        np.save(os.path.join(output_dir, f"{i:06}_s.npy"),
                (seg - 1)[None].cpu().numpy())


class E5SentenceEmbedder:
    """e5-mistral-7b-instruct through sentence_transformers, from a local
    copy of the checkpoint."""

    def __init__(self, model_path=None, device=None):
        st = local_model(model_path, E5_MODEL, "sentence_transformers")
        self.device = resolve_device(device)
        self.model = st.SentenceTransformer(
            model_path, device=str(self.device), local_files_only=True)
        self.model.max_seq_length = 4096

    def __call__(self, text: str) -> torch.Tensor:
        return self.model.encode(text, convert_to_tensor=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="Video language features")
    p.add_argument("--feature_name", type=str, default="features")
    p.add_argument("--segmentation_dir", type=str, required=True)
    p.add_argument("--output_name", type=str, default="final_features")
    p.add_argument("--caption_dir", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help=f"a local copy of {E5_MODEL} (required)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    args = p.parse_args(argv)
    embedder = E5SentenceEmbedder(args.model_path, args.device)
    encode_feature(args.caption_dir, args.feature_name,
                   args.segmentation_dir, embedder, device=args.device)
    assemble_final_features(
        os.path.join(args.caption_dir, args.feature_name),
        args.segmentation_dir,
        os.path.join(args.caption_dir, args.output_name), args.device)


if __name__ == "__main__":
    main()
