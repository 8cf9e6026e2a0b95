"""The eval's text tower from a local CLIP, JAX package vs the port, on the
CPU: a tiny CLIP (2 layers, width 32, projection 16) initialised from a
seed and saved with its processor (a default CLIPImageProcessor and a
CLIPTokenizer over a vocabulary the test writes) in a temporary directory.
Nothing is downloaded.

- the JAX package's `TransformersClipEmbedder(<dir>)` and the port's give
  the same rows within 1e-6;
- without a local directory, or without transformers, the port's class
  raises and names the model (tests/test_torch_import.py holds that no
  module of the port imports transformers);
- `python -m langsplat4d_torch.eval --clip_model_path <dir>` gives the same
  Mean IoU as with a cache of the same rows.
"""
import json
import os
import re
import sys

# transformers loads TensorFlow where it is installed unless told not to
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from langsplat4d.eval import relevancy as JR  # noqa: E402
from langsplat4d_torch.eval import relevancy as TR  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "golden_quality")
CLIP_DIM = 16                       # the golden AE's decoded width
PROMPTS = ["ball", "red ball", "a cup", *TR.NEGATIVES]


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A seeded tiny CLIP and its processor, saved as from_pretrained reads
    them."""
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel,
                              CLIPProcessor, CLIPTokenizer)
    d = str(tmp_path_factory.mktemp("tiny_clip"))
    letters = "abcdefghijklmnopqrstuvwxyz"
    tokens = [*letters, *(c + "</w>" for c in letters), "ba", "bal",
              "ball</w>", "<|startoftext|>", "<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(tokens)}
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nb a\nba l\nbal l</w>\n")
    tok = CLIPTokenizer(os.path.join(d, "vocab.json"),
                        os.path.join(d, "merges.txt"))
    CLIPProcessor(image_processor=CLIPImageProcessor(),
                  tokenizer=tok).save_pretrained(d)
    end = vocab["<|endoftext|>"]
    cfg = CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=32,
                         bos_token_id=vocab["<|startoftext|>"],
                         eos_token_id=end, pad_token_id=end),
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=16),
        projection_dim=CLIP_DIM)
    torch.manual_seed(0)
    CLIPModel(cfg).save_pretrained(d)
    return d


def test_text_tower_matches_jax(clip_dir):
    want = JR.TransformersClipEmbedder(clip_dir).encode(PROMPTS)
    port = TR.TransformersClipEmbedder(clip_dir, device="cpu")
    got = port.encode(PROMPTS)
    assert got.shape == (len(PROMPTS), CLIP_DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    # prompts of different lengths give different rows
    assert np.abs(got[0] - got[1]).max() > 1e-3
    np.testing.assert_allclose(port.negatives(), got[3:], rtol=0, atol=1e-6)
    emb = TR.make_text_embedder(None, clip_dir, device="cpu")
    np.testing.assert_array_equal(emb.encode(PROMPTS), got)


def test_text_tower_refuses_without_local_files(tmp_path, monkeypatch):
    for path in (None, str(tmp_path / "absent")):
        with pytest.raises(RuntimeError,
                           match="laion/CLIP-ViT-B-16-laion2B-s34b-b88k"):
            TR.TransformersClipEmbedder(path, device="cpu")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="needs the 'transformers' "
                       "package"):
        TR.TransformersClipEmbedder(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="--clip_model_path"):
        TR.make_text_embedder(None, None)


def _eval_inputs(work):
    """Renders of 3-d features for 2 frames at 3 levels, a COCO file with
    a box per frame under the prompt "ball", the golden AE."""
    rng = np.random.default_rng(3)
    hw, it = 24, 7
    root = work / "exps"
    for level in (1, 2, 3):
        d = root / f"tiny_{level}" / "video_lang" / f"ours_{it}" / \
            "renders_npy"
        d.mkdir(parents=True)
        for fi in range(2):
            feat = rng.uniform(0.1, 0.9, (hw, hw, 3)).astype(np.float32)
            feat[6:16, 5:14] = rng.uniform(0.6, 0.9, 3)
            np.save(d / f"{fi:05d}.npy", feat)
    ann = work / "annot" / "train"
    ann.mkdir(parents=True)
    images, annotations = [], []
    for k in range(2):
        images.append({"id": k, "file_name": f"{k + 1:05d}_png.rf.q{k}.jpg",
                       "height": hw, "width": hw})
        annotations.append({
            "id": k, "image_id": k, "category_id": 1,
            "bbox": [5.0, 6.0, 9.0, 10.0],
            "segmentation": [[5, 6, 14, 6, 14, 16, 5, 16]]})
    with open(ann / "_annotations.coco.json", "w") as f:
        json.dump({"categories": [{"id": 1, "name": "ball"}],
                   "images": images, "annotations": annotations}, f)
    return ["--exp_name", "tiny", "--iterations", str(it),
            "--annotation_folder", str(work / "annot"),
            "--ae_ckpt_path", os.path.join(FIXTURE, "ae_best_ckpt.pth"),
            "--encoder_hidden_dims", "8", "3", "--decoder_hidden_dims", "8",
            str(CLIP_DIM), "--feat_dim", "3", "--dataset_type", "hypernerf",
            "--feat_root", str(root), "--device", "cpu"]


def test_eval_cli_with_clip_model_path(clip_dir, tmp_path, capsys):
    """The eval CLI's Mean IoU with --clip_model_path equals its Mean IoU
    with a cache of the same rows."""
    from langsplat4d_torch.eval.__main__ import main
    argv = _eval_inputs(tmp_path)
    rows = TR.TransformersClipEmbedder(clip_dir, device="cpu").encode(
        ["ball", *TR.NEGATIVES])
    cache = str(tmp_path / "cache.npz")
    np.savez(cache, **dict(zip(["ball", *TR.NEGATIVES], rows)))
    ious = []
    for tag, extra in (("model", ["--clip_model_path", clip_dir]),
                       ("cache", ["--text_embedding_cache", cache])):
        capsys.readouterr()
        got = main(argv + extra + ["--output_path", str(tmp_path / tag)])
        m = re.findall(r"^Mean IoU: (\S+)$", capsys.readouterr().out, re.M)
        assert len(m) == 1 and float(m[0]) == got
        ious.append(got)
    assert ious[0] == ious[1]
    assert 0.0 < ious[0] <= 1.0
