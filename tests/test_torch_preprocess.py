"""Offline preprocessing, JAX package vs the port (langsplat4d_torch/
preprocess/) on the CPU: mask NMS, the CLIP segment tiles and seg maps,
the per-object visual prompts, the captions' CSVs and the video features,
on the same seeded inputs, and the port's own cv2 resize against cv2.

Every comparison is exact: the NMS indices, the tiles (the port's resize is
byte-equal to cv2's uint8 INTER_LINEAR on every square size from 1 px to
1352 px, Neu3D's frame width and the largest padded square of any preset), the seg maps, the prompt images and the PNG and NPY files byte for
byte."""
import csv
import io
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from langsplat4d.preprocess import clip_features as JC
from langsplat4d.preprocess import image_prompt as JP
from langsplat4d.preprocess import mask_nms as JN
from langsplat4d.preprocess import video_captions as JV
from langsplat4d.preprocess import video_features as JF
from langsplat4d_torch.preprocess import clip_features as TC
from langsplat4d_torch.preprocess import image_prompt as TP
from langsplat4d_torch.preprocess import mask_nms as TN
from langsplat4d_torch.preprocess import video_captions as TV
from langsplat4d_torch.preprocess import video_features as TF
import test_preprocess as JT

CPU = "cpu"


def voronoi_stack(seed, hw=(48, 64), counts=(9, 6, 3, 0)):
    """[4, H, W] int32 stack of nearest-seed segments a level, with an
    absent label (a hole of background), a one-row segment (a zero-height
    box, which mask2segmap drops) and an empty level."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    stack = np.zeros((4, h, w), np.int32)
    for lvl, n in enumerate(counts):
        if n:
            c = rng.integers(0, (h, w), (n, 2))
            d = (yy[..., None] - c[:, 0]) ** 2 + (xx[..., None] - c[:, 1]) ** 2
            stack[lvl] = d.argmin(-1) + 1
    stack[0][stack[0] == 2] = 0
    stack[1, 5, 3:20] = counts[1] + 3
    return stack


def image_of(seed, hw=(48, 64)):
    return np.random.default_rng(seed + 50).integers(
        0, 256, hw + (3,), dtype=np.uint8)


def port_encoder(jax_encoder):
    return lambda tiles: torch.from_numpy(jax_encoder(tiles.numpy()))


# ---- clip_features ---------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 1])
def test_masks_and_segmaps_match_jax(seed):
    """masks_from_stack (labels, boxes, segmentations) and mask2segmap
    (tiles and seg map) of every level, on the JAX test's stack and on
    seeded Voronoi stacks."""
    if seed is None:
        stack, img = JT.TestClipFeatures().make_stack(), image_of(0, (32, 32))
    else:
        stack, img = voronoi_stack(seed), image_of(seed)
    want = JC.masks_from_stack(stack)
    got = TC.masks_from_stack(torch.from_numpy(stack), device=CPU)
    assert [len(lv) for lv in got] == [len(lv) for lv in want]
    for w_lvl, g_lvl in zip(want, got):
        for w, g in zip(w_lvl, g_lvl):
            assert g["label"] == w["label"]
            assert g["bbox"] == [int(v) for v in w["bbox"]]
            np.testing.assert_array_equal(g["segmentation"].numpy(),
                                          w["segmentation"])
        w_tiles, w_map = JC.mask2segmap(w_lvl, img)
        g_tiles, g_map = TC.mask2segmap(g_lvl, torch.from_numpy(img),
                                        device=CPU)
        np.testing.assert_array_equal(g_tiles.numpy(), w_tiles)
        assert g_map.dtype == torch.int32
        np.testing.assert_array_equal(g_map.numpy(), w_map)


RESIZE_SIDE = 1352        # Neu3D's width: the largest padded square
RESIZE_SPAN = 169         # sizes a case


@pytest.mark.parametrize("lo", range(1, RESIZE_SIDE + 1, RESIZE_SPAN))
def test_resize_is_cv2_on_every_square_size(lo):
    """crop_pad_resize of whole square boxes against cv2.resize(INTER_
    LINEAR) to 224x224, byte for byte, on every size from 1 to 1352 px
    (169 sizes a case)."""
    big = np.random.default_rng(7).integers(
        0, 256, (RESIZE_SIDE, RESIZE_SIDE, 3), dtype=np.uint8)
    big[:40] = 255                       # saturated rows
    img = torch.from_numpy(big)
    whole = torch.ones((25, RESIZE_SIDE, RESIZE_SIDE), dtype=torch.bool)
    for first in range(lo, lo + RESIZE_SPAN, 25):
        sizes = range(first, min(first + 25, lo + RESIZE_SPAN))
        boxes = torch.tensor([[0, 0, s, s] for s in sizes])
        got = TC.crop_pad_resize(img, whole[:len(boxes)], boxes).numpy()
        for tile, s in zip(got, sizes):
            np.testing.assert_array_equal(tile, cv2.resize(big[:s, :s],
                                                           (224, 224)),
                                          err_msg=f"size {s}")


def test_crop_pad_resize_is_the_reference_loop():
    """Segments of every shape (tall, wide, square, one pixel wide) cut
    from an image in one batched call against the reference's per-tile
    get_seg_img -> pad_img -> cv2.resize, and the port's own get_seg_img
    and pad_img against the JAX package's."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    boxes = [(0, 0, 1, 50), (10, 5, 37, 2), (119 - 17, 60, 17, 29),
             (3, 3, 40, 40), (50, 0, 69, 89), (7, 80, 2, 9)]
    segs = rng.random((len(boxes), 90, 120)) < 0.7
    got = TC.crop_pad_resize(torch.from_numpy(img), torch.from_numpy(segs),
                             torch.tensor(boxes)).numpy()
    for k, (box, seg) in enumerate(zip(boxes, segs)):
        mask = {"segmentation": seg, "bbox": list(box)}
        padded = JC.pad_img(JC.get_seg_img(mask, img))
        np.testing.assert_array_equal(got[k], cv2.resize(padded, (224, 224)))
        port = TC.pad_img(TC.get_seg_img(
            {"segmentation": torch.from_numpy(seg), "bbox": list(box)},
            torch.from_numpy(img)))
        np.testing.assert_array_equal(port.numpy(), padded)


@pytest.mark.parametrize("seed", [None, 2])
def test_create_frame_features_matches_jax(seed):
    """With the JAX test's fake encoder: equal seg maps (the cross-level
    offsets) and equal fp16 features (the tiles are byte-equal, and numpy's
    and torch's float32 norms agree on these rows)."""
    if seed is None:
        stack, img = JT.TestClipFeatures().make_stack(), image_of(0, (32, 32))
    else:
        stack, img = voronoi_stack(seed, counts=(9, 6, 4, 2)), image_of(seed)
    w_feats, w_map = JC.create_frame_features(img, stack, JT.fake_encoder())
    g_feats, g_map = TC.create_frame_features(
        torch.from_numpy(img), stack, port_encoder(JT.fake_encoder()),
        device=CPU)
    assert g_feats.dtype == torch.float16 and g_map.dtype == torch.int32
    np.testing.assert_array_equal(g_map.numpy(), w_map)
    np.testing.assert_array_equal(g_feats.numpy(), w_feats)


def test_process_sequence_writes_the_jax_files(tmp_path):
    """RGB, RGBA and grey PNGs (PIL's convert("RGB"): alpha dropped, grey
    replicated) through both packages' process_sequence: the *_f.npy and
    *_s.npy files byte for byte."""
    paths, segs = [], []
    for k, mode in enumerate(("RGB", "RGBA", "L")):
        arr = np.random.default_rng(k).integers(0, 256, (48, 64, 4),
                                                dtype=np.uint8)
        pil = Image.fromarray(arr, "RGBA").convert(mode)
        paths.append(str(tmp_path / f"{k:06}.png"))
        pil.save(paths[-1])
        segs.append(str(tmp_path / f"{k:06}.npy"))
        np.save(segs[-1], voronoi_stack(k + 10))
    JC.process_sequence(paths, segs, str(tmp_path / "jax"), JT.fake_encoder())
    TC.process_sequence(paths, segs, str(tmp_path / "port"),
                        port_encoder(JT.fake_encoder()), device=CPU)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n


# ---- mask_nms -------------------------------------------------------------

def nms_case(seed):
    """Seeded SAM-style candidates: rectangles and blobs, near-duplicates
    (one edge moved), masks contained in others, an empty mask, and scores
    on a coarse grid (ties); every third seed has every score below the
    threshold (the top-3 fallback)."""
    rng = np.random.default_rng(seed)
    hw = 40
    masks = []
    for _ in range(rng.integers(4, 14)):
        y0, x0 = rng.integers(0, hw - 4, 2)
        y1, x1 = y0 + rng.integers(2, hw - y0 + 1), x0 + rng.integers(
            2, hw - x0 + 1)
        m = np.zeros((hw, hw), bool)
        m[y0:y1, x0:x1] = True
        masks.append(m)
        if rng.random() < 0.4:                     # near-duplicate
            d = m.copy()
            d[y0:y1, x1 - 1] = False
            masks.append(d)
        if rng.random() < 0.4 and y1 - y0 > 4 and x1 - x0 > 4:   # contained
            c = np.zeros_like(m)
            c[y0 + 1:y1 - 1, x0 + 1:x1 - 1] = rng.random(
                (y1 - y0 - 2, x1 - x0 - 2)) < 0.9
            masks.append(c)
    masks.append(np.zeros((hw, hw), bool))
    masks = np.stack(masks)
    scores = np.round(rng.random(len(masks)) * 20) / 20
    if seed % 3 == 0:
        scores *= 0.09
    return masks, scores


@pytest.mark.parametrize("seed", range(12))
def test_mask_nms_matches_jax(seed):
    masks, scores = nms_case(seed)
    for kw in ({}, dict(iou_thr=0.5, inner_thr=0.4, score_thr=0.3)):
        want = JN.mask_nms(masks, scores, **kw)
        got = TN.mask_nms(torch.from_numpy(masks), scores, device=CPU, **kw)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_mask_nms_jax_cases_and_masks_update():
    """The JAX tests' own cases, and masks_update on two levels of SAM
    dicts (and an empty level): the same surviving dicts."""
    t = JT.TestMaskNMS()
    big, dup = t._blob(2, 30, 2, 30), t._blob(2, 30, 2, 29)
    masks = np.stack([big, dup, t._blob(10, 20, 10, 20),
                      t._blob(0, 8, 24, 32)])
    for scores in ([0.9, 0.8, 0.7, 0.6], [0.05, 0.04, 0.03, 0.02],
                   [0.9, 0.05, 0.8, 0.04]):
        np.testing.assert_array_equal(
            TN.mask_nms(masks, np.asarray(scores), device=CPU).numpy(),
            JN.mask_nms(masks, np.asarray(scores)))
    assert len(TN.mask_nms(np.zeros((0, 4, 4), bool), [], device=CPU)) == 0
    rng = np.random.default_rng(5)
    levels = []
    for seed in (1, 2):
        m, s = nms_case(seed)
        levels.append([{"segmentation": seg, "stability_score": float(a),
                        "predicted_iou": float(b), "id": i}
                       for i, (seg, a, b) in enumerate(
                           zip(m, s, rng.random(len(s)) * 0.5 + 0.5))])
    levels.append([])
    want = JN.masks_update(*levels)
    got = TN.masks_update(*levels, device=CPU)
    assert [[m["id"] for m in lv] for lv in got] == \
        [[m["id"] for m in lv] for lv in want]


# ---- image_prompt ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 32, 3), (64, 80, 3), (12, 7, 3),
                                   (40, 30, 4), (33, 17, 1), (20, 25, 2)])
def test_highlight_object_is_pils(shape):
    """The composite byte for byte against PIL's (the JAX package's), with
    masks that touch the image's edges and corners; RGB, RGBA, grey and
    grey + alpha frames (12x7 is narrower than the blur's window); and the
    PNG of it byte for byte against PIL's save."""
    h, w, c = shape
    arr = np.random.default_rng(h * w).integers(0, 256, shape,
                                                dtype=np.uint8)
    img = Image.fromarray(arr[..., 0] if c == 1 else arr,
                          {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c])
    mask = np.zeros((h, w), bool)
    mask[h // 4:3 * h // 4, :w // 2] = True            # the left edge
    mask[0, w - 3:] = True                             # the top right corner
    mask[h - 1, w // 2 + 1] = True                     # one pixel, bottom
    want = JP.highlight_object(img, mask)
    got = TP.highlight_object(arr, mask, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    buf = io.BytesIO()
    want.save(buf, format="PNG")
    assert TP.png_from_rows(TP.pillow_rows(got).numpy(), w, 4,
                            pillow=True) == buf.getvalue()


def write_prompt_scene(root, frames=2, hw=(32, 40)):
    rng = np.random.default_rng(11)
    (root / "img").mkdir()
    (root / "mask").mkdir()
    for i in range(1, frames + 1):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                        ).save(root / "img" / f"{i:06}.png")
        m = np.zeros(hw, np.int32)
        m[4:20, 3:15] = 1
        m[10:, 25:] = 2 + i            # id 3 in frame 1, 4 in frame 2
        np.save(root / "mask" / f"{i:06}.npy", m)


def test_process_frames_writes_pils_files(tmp_path):
    """Both packages' collect_unique_ids and process_frames on one scene:
    the same ids, the same directories and every PNG byte for byte (the
    background id 0 included, as the reference does)."""
    write_prompt_scene(tmp_path)
    md, imd = str(tmp_path / "mask"), str(tmp_path / "img")
    ids = JP.collect_unique_ids(md, 2)
    assert TP.collect_unique_ids(md, 2, device=CPU) == ids == {0, 1, 3, 4}
    JP.process_frames(ids, 2, md, imd, str(tmp_path / "jax"))
    TP.process_frames(ids, 2, md, imd, str(tmp_path / "port"), device=CPU)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "port")
        for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert len(files) == 6             # ids 0 and 1 twice, 3 and 4 once
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def test_process_frames_bounds_the_prompts_in_flight(tmp_path,
                                                     monkeypatch):
    """With PNG writes far slower than the prompts are made (the writers
    wait until the queue is full, then take 10 ms each), at most
    MAX_PENDING prompts wait for them (one more while it is being queued),
    and every prompt is still written."""
    import threading
    import time
    rng = np.random.default_rng(4)
    (tmp_path / "img").mkdir()
    (tmp_path / "mask").mkdir()
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                    ).save(tmp_path / "img" / "000001.png")
    np.save(tmp_path / "mask" / "000001.npy",
            np.arange(256, dtype=np.int32).reshape(16, 16) % 48)
    lock, live, peak = threading.Lock(), [0], [0]
    full = threading.Event()             # the writers start once it is full
    rows_of, write = TP.pillow_rows, TP._write_png

    def made(img):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            if live[0] > TP.MAX_PENDING:
                full.set()
        return rows_of(img)

    def slow_write(*args):
        full.wait(10)
        time.sleep(0.01)
        write(*args)
        with lock:
            live[0] -= 1
    monkeypatch.setattr(TP, "pillow_rows", made)
    monkeypatch.setattr(TP, "_write_png", slow_write)
    TP.process_frames(range(48), 1, str(tmp_path / "mask"),
                      str(tmp_path / "img"), str(tmp_path / "out"),
                      device=CPU)
    assert live[0] == 0
    assert peak[0] == TP.MAX_PENDING + 1 < 48
    assert len(os.listdir(tmp_path / "out")) == 48


def test_image_prompt_main_writes_frames_and_no_video(tmp_path, capsys):
    write_prompt_scene(tmp_path)
    out = tmp_path / "prompts"
    ids = TP.main(["--mask_dir", str(tmp_path / "mask"), "--image_dir",
                   str(tmp_path / "img"), "--output_dir", str(out),
                   "--device", CPU])
    assert ids == {0, 1, 3, 4}
    assert sorted(os.listdir(out)) == ["00", "01", "03", "04"]
    assert "no mp4s" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="01.mp4"):
        TP.pic2video(str(out / "01"), str(out / "01.mp4"))


# ---- video_captions and video_features ------------------------------------

class FakeCaptioner:
    def caption_video(self, frame_paths, prompt):
        return f"{len(frame_paths)} frames from {frame_paths[0][-10:]}"

    def caption_frames(self, frame_paths, prompt):
        return "|".join(os.path.basename(p) for p in frame_paths) + prompt[:9]


def test_generate_captions_writes_the_jax_csvs(tmp_path):
    for obj, n in ((1, 9), (4, 2)):
        d = tmp_path / "prompts" / f"{obj:02}"
        d.mkdir(parents=True)
        for i in range(1, n + 1):
            (d / f"{i:06}.png").write_bytes(b"")
    assert TV.VIDEO_PROMPT == JV.VIDEO_PROMPT
    assert TV.FRAME_PROMPT == JV.FRAME_PROMPT
    JV.generate_captions(str(tmp_path / "prompts"), str(tmp_path / "jax"),
                         FakeCaptioner(), context=2)
    TV.generate_captions(str(tmp_path / "prompts"), str(tmp_path / "port"),
                         FakeCaptioner(), context=2)
    for name in ("output_text_id1.csv", "output_text_id4.csv"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_video_features_write_the_jax_files(tmp_path):
    """encode_feature (float64 tables, 1-based frame ids from the CSV paths)
    and assemble_final_features (the `seg - 1` shift, the level axis) on
    the JAX test's inputs with a float32 embedder and an object absent
    from a frame: every file byte for byte."""
    seg_dir, n_frames = tmp_path / "segs", 3
    seg_dir.mkdir()
    for i in range(1, n_frames + 1):
        seg = np.zeros((8, 8), np.int32)
        seg[:4] = 1
        seg[4:] = 2 + (i == 2)
        np.save(seg_dir / f"{i:06}.npy", seg)
    for root in ("jax", "port"):
        cap = tmp_path / root
        cap.mkdir()
        for obj in (1, 2, 3):
            with open(cap / f"output_text_id{obj}.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["frame", "cap"])
                for i in range(1, n_frames + 1):
                    if obj != 3 or i == 2:
                        w.writerow([f"x/{i:06}.png", f"obj{obj} frame{i}"])

    def encode_text(text):
        return np.random.default_rng(sum(map(ord, text))).standard_normal(
            16).astype(np.float32)
    JF.encode_feature(str(tmp_path / "jax"), "features", str(seg_dir),
                      encode_text, embed_dim=16)
    TF.encode_feature(str(tmp_path / "port"), "features", str(seg_dir),
                      encode_text, embed_dim=16, device=CPU)
    JF.assemble_final_features(str(tmp_path / "jax" / "features"),
                               str(seg_dir), str(tmp_path / "jax" / "final"))
    TF.assemble_final_features(str(tmp_path / "port" / "features"),
                               str(seg_dir), str(tmp_path / "port" / "final"),
                               device=CPU)
    for sub in ("features", "final"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        for n in names:
            assert ((tmp_path / "port" / sub / n).read_bytes()
                    == (tmp_path / "jax" / sub / n).read_bytes()), (sub, n)
    assert np.load(tmp_path / "port" / "features" / "000001.npy").dtype \
        == np.float64


# ---- the models: never downloaded ----------------------------------------

@pytest.mark.parametrize("make, model", [
    (lambda: TC.TransformersClipImageEncoder(None, device=CPU), "CLIP"),
    (lambda: TV.Qwen2VLCaptioner(device=CPU), "Qwen2-VL-7B-Instruct"),
    (lambda: TF.E5SentenceEmbedder("/nonexistent", device=CPU),
     "e5-mistral-7b-instruct"),
    (lambda: TC.main(["--scene_path", ".", "--mask_dir", "."]), "CLIP"),
    (lambda: TV.main(["--prompt_image_dir", ".", "--output_dir", "."]),
     "Qwen2-VL-7B-Instruct"),
    (lambda: TF.main(["--caption_dir", ".", "--segmentation_dir", "."]),
     "e5-mistral-7b-instruct")])
def test_models_raise_and_name_themselves_without_a_local_copy(make, model):
    with pytest.raises(RuntimeError, match=model):
        make()
