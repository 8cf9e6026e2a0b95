"""CLIP relevancy scoring (port of langsplat4d/eval/relevancy.py; reference
eval/openclip_encoder.py).

The relevancy is a pairwise softmax at temperature 10 of each positive
phrase against the 4 canonical negatives, taking the negative that leaves
the positive the least probability (:41-56). Its products run in full fp32
(TF32 off), as the JAX package runs them at `Precision.HIGHEST`. Text
embeddings come from a precomputed .npz cache (`CachedTextEmbedder`); the
JAX package's transformers CLIP encoder needs a downloaded model and is not
ported, so `make_text_embedder` without a cache path raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from langsplat4d_torch.core.device import fp32_matmul

NEGATIVES = ("object", "things", "stuff", "texture")


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


def make_text_embedder(cache_path: Optional[str] = None) -> TextEmbedder:
    if cache_path:
        return CachedTextEmbedder(cache_path)
    raise NotImplementedError(
        "text embeddings come from a precomputed cache in the port: pass "
        "--text_embedding_cache <prompts.npz> (the transformers CLIP encoder "
        "needs a downloaded model and is not ported)")
