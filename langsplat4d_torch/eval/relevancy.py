"""CLIP relevancy scoring (port of langsplat4d/eval/relevancy.py; reference
eval/openclip_encoder.py).

The relevancy is a pairwise softmax at temperature 10 of each positive
phrase against the 4 canonical negatives, taking the negative that leaves
the positive the least probability (:41-56). Its products run in full fp32
(TF32 off), as the JAX package runs them at `Precision.HIGHEST`. Text
embeddings come from a precomputed .npz cache (`CachedTextEmbedder`) or
from CLIP's text tower through transformers (`TransformersClipEmbedder`),
read from a local copy of the model only: nothing is downloaded, so
`make_text_embedder` with neither a cache nor a model path raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from langsplat4d_torch.core.device import fp32_matmul, resolve_device
from langsplat4d_torch.preprocess import local_model

NEGATIVES = ("object", "things", "stuff", "texture")
# the JAX package's default; the reference's open_clip ViT-B-16
# laion2b_s34b_b88k (openclip_encoder.py:18-19)
CLIP_TEXT_MODEL = "laion/CLIP-ViT-B-16-laion2B-s34b-b88k"


def relevancy(embeds: torch.Tensor, pos_embeds: torch.Tensor,
              neg_embeds: torch.Tensor) -> torch.Tensor:
    """embeds [N, D] (L2-normalised CLIP features), pos_embeds [P, D],
    neg_embeds [G, D] -> [N, P]: per positive, the least of
    sigmoid(10 pos - 10 neg_g) over the negatives."""
    with fp32_matmul():
        pos_sim = embeds @ pos_embeds.T                        # [N, P]
        neg_sim = embeds @ neg_embeds.T                        # [N, G]
    pair = torch.sigmoid(10.0 * pos_sim[:, :, None]
                         - 10.0 * neg_sim[:, None, :])         # [N, P, G]
    return pair.amin(dim=-1)


def relevancy_maps(sem_map: torch.Tensor, pos_embeds: torch.Tensor,
                   neg_embeds: torch.Tensor) -> torch.Tensor:
    """[L, H, W, D] decoded features -> [L, P, H, W] relevancy maps
    (reference get_max_across, openclip_encoder.py:96-112)."""
    l, h, w, d = sem_map.shape
    rel = relevancy(sem_map.reshape(-1, d), pos_embeds, neg_embeds)
    return rel.reshape(l, h, w, -1).permute(0, 3, 1, 2)


class TextEmbedder:
    """Prompt -> CLIP text embedding provider (numpy, L2-normalised)."""

    def encode(self, prompts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def negatives(self) -> np.ndarray:
        out = self.encode(list(NEGATIVES))
        return out / np.linalg.norm(out, axis=-1, keepdims=True)


class CachedTextEmbedder(TextEmbedder):
    """Embeddings from an .npz file {prompt: [D] array} produced offline."""

    def __init__(self, path: str):
        self.table: Dict[str, np.ndarray] = dict(np.load(path))

    def encode(self, prompts: Sequence[str]) -> np.ndarray:
        rows = []
        for p in prompts:
            if p not in self.table:
                raise KeyError(f"prompt {p!r} missing from embedding cache; "
                               f"available: {sorted(self.table)[:10]}...")
            rows.append(self.table[p])
        out = np.stack(rows).astype(np.float32)
        return out / np.linalg.norm(out, axis=-1, keepdims=True)


class TransformersClipEmbedder(TextEmbedder):
    """CLIP's text tower through transformers, from `model_path`, a local
    directory holding the model and its processor (the JAX package's class
    of the same name, langsplat4d/eval/relevancy.py). The prompts are padded
    to the longest and encoded by `get_text_features` on `device` (None:
    the current CUDA device), in fp32 with TF32 off; the rows come back as
    float32, L2-normalised. `transformers` is imported here, and without it
    or without the directory this raises, naming the model."""

    def __init__(self, model_path=None, device=None):
        transformers = local_model(model_path, CLIP_TEXT_MODEL,
                                   "transformers")
        self.device = resolve_device(device)
        self.model = transformers.CLIPModel.from_pretrained(
            model_path, local_files_only=True).float().to(self.device).eval()
        self.processor = transformers.CLIPProcessor.from_pretrained(
            model_path, local_files_only=True)

    def encode(self, prompts: Sequence[str]) -> np.ndarray:
        inputs = self.processor(text=list(prompts), return_tensors="pt",
                                padding=True)
        with torch.no_grad(), fp32_matmul():
            out = self.model.get_text_features(
                **{k: v.to(self.device) for k, v in inputs.items()})
        out = out.float().cpu().numpy()
        return out / np.linalg.norm(out, axis=-1, keepdims=True)


def make_text_embedder(cache_path: Optional[str] = None,
                       model_path: Optional[str] = None,
                       device=None) -> TextEmbedder:
    """The eval's prompt encoder: the .npz cache where one is given, else
    CLIP's text tower from the local `model_path` on `device`; with
    neither, this raises."""
    if cache_path:
        return CachedTextEmbedder(cache_path)
    if model_path:
        return TransformersClipEmbedder(model_path, device=device)
    raise NotImplementedError(
        f"no text embeddings: pass --text_embedding_cache <prompts.npz> or "
        f"--clip_model_path <a local copy of {CLIP_TEXT_MODEL}> (nothing is "
        f"downloaded)")
