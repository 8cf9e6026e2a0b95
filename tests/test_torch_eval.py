"""Open-vocabulary evaluation, JAX package vs the port: relevancy, pooling
and mask smoothing, polygon masks against OpenCV, the colormaps and PCA
against matplotlib and scikit-learn, `activate_stream` with both level
strategies and the adaptive threshold, and the video helpers."""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.eval import colormaps as JC
from langsplat4d.eval import evaluate as JE
from langsplat4d.eval import relevancy as JR
from langsplat4d_torch.eval import colormaps as TC
from langsplat4d_torch.eval import evaluate as TE
from langsplat4d_torch.eval import relevancy as TR


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def test_relevancy_matches_jax():
    rng = np.random.default_rng(0)
    emb = _unit(rng.normal(size=(500, 16)))
    pos, neg = _unit(rng.normal(size=(3, 16))), _unit(rng.normal(size=(4, 16)))
    want = np.asarray(JR.relevancy(jnp.asarray(emb), jnp.asarray(pos),
                                   jnp.asarray(neg)))
    got = TR.relevancy(torch.from_numpy(emb), torch.from_numpy(pos),
                       torch.from_numpy(neg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sem = _unit(rng.normal(size=(3, 20, 24, 16)))
    want = np.asarray(JR.relevancy_maps(jnp.asarray(sem), jnp.asarray(pos),
                                        jnp.asarray(neg)))
    got = TR.relevancy_maps(torch.from_numpy(sem), torch.from_numpy(pos),
                            torch.from_numpy(neg)).numpy()
    assert got.shape == (3, 3, 20, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_text_embedder(tmp_path):
    rng = np.random.default_rng(1)
    table = {k: rng.normal(size=8).astype(np.float32)
             for k in ("ball", *TR.NEGATIVES)}
    path = str(tmp_path / "cache.npz")
    np.savez(path, **table)
    j, t = JR.make_text_embedder(path), TR.make_text_embedder(path)
    np.testing.assert_array_equal(t.encode(["ball"]), j.encode(["ball"]))
    np.testing.assert_array_equal(t.negatives(), j.negatives())
    with pytest.raises(KeyError):
        t.encode(["cup"])
    with pytest.raises(NotImplementedError, match="--text_embedding_cache"):
        TR.make_text_embedder(None)


def test_pooling_and_mask_smoothing_are_exact():
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2, 3, 40, 52)).astype(np.float32)
    got = TE.smooth_heatmaps(torch.from_numpy(x), 29).numpy()
    for i in range(2):
        for k in range(3):
            pooled = np.asarray(JE._avg_pool_same(jnp.asarray(x[i, k]), 29,
                                                  14))
            np.testing.assert_array_equal(got[i, k], 0.5 * (pooled + x[i, k]))
    m = (rng.uniform(size=(40, 52)) > 0.55).astype(np.uint8)
    np.testing.assert_array_equal(
        TE.smooth_mask(torch.from_numpy(m)).numpy(),
        np.asarray(JE.smooth_mask(jnp.asarray(m))))
    np.testing.assert_array_equal(
        TE.majority_smooth(torch.from_numpy(m)).numpy(),
        JE.majority_smooth(m))
    np.testing.assert_array_equal(
        TE.majority_smooth(torch.from_numpy(m.astype(bool))).numpy(),
        JE.majority_smooth(m).astype(bool))


def _blob_mask(rng, h, w, n=3):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
        ry, rx = rng.uniform(2, 10), rng.uniform(2, 10)
        m |= ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1).astype(
            np.uint8)
    return m


def test_polygon_masks_of_contours_equal_opencv():
    """The contours cv2.findContours gives for seeded blob masks, filled by
    the port and by cv2.fillPoly (the JAX package): the same pixels."""
    rng = np.random.default_rng(3)
    n = 0
    for _ in range(25):
        m = _blob_mask(rng, 48, 64)
        cnts, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        for c in cnts:
            pts = c.reshape(-1, 2).astype(float).tolist()
            np.testing.assert_array_equal(
                TE.polygon_to_mask((48, 64), pts),
                JE.polygon_to_mask((48, 64), pts))
            n += 1
    assert n > 40


def _seg_dist(p, a, b):
    ab = b - a
    t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0, 1)
    return np.linalg.norm(p - (a + t * ab))


def test_random_polygons_differ_only_within_half_a_pixel_of_an_edge():
    """Seeded random polygons (3-11 vertices inside the image, convex or
    not): the port's fill and cv2.fillPoly differ only on pixels whose
    centre lies within 0.5 px of an edge of the truncated polygon, where
    the two line walks round differently."""
    rng = np.random.default_rng(4)
    h, w = 40, 50
    n_diff = 0
    for _ in range(100):
        k = int(rng.integers(3, 12))
        pts = np.stack([rng.uniform(0, w - 1, k),
                        rng.uniform(0, h - 1, k)], 1).tolist()
        a = JE.polygon_to_mask((h, w), pts)
        b = TE.polygon_to_mask((h, w), pts)
        poly = np.asarray(pts, dtype=np.int32).astype(float)
        for y, x in np.argwhere(a != b):
            d = min(_seg_dist(np.array([x, y], float), poly[i],
                              poly[(i + 1) % k]) for i in range(k))
            assert d <= 0.5, (pts, x, y, d)
            n_diff += 1
    assert n_diff < 0.01 * 100 * h * w


def test_stack_mask():
    a = np.array([[0, 1], [0, 0]], np.uint8)
    b = np.array([[0, 0], [3, 0]], np.uint8)
    np.testing.assert_array_equal(TE.stack_mask(a, b), JE.stack_mask(a, b))


def test_turbo_table_and_scalar_colormap():
    import matplotlib
    lut = matplotlib.colormaps["turbo"](np.arange(256) / 255.0)[:, :3]
    assert np.abs(TC.TURBO - lut).max() <= 2 / 255
    x = np.random.default_rng(5).uniform(-0.2, 1.2, size=(30, 40, 1))
    opts = TC.ColormapOptions(normalize=True, colormap_min=-1.0,
                              colormap_max=1.0)
    got = TC.apply_colormap(x, opts)
    v = x[..., 0] - x.min()
    v = np.clip(v / (v.max() + 1e-9) * 2 - 1, 0, 1)
    want = matplotlib.colormaps["turbo"](v)[..., :3]
    assert np.abs(got - want).max() <= 2 / 255
    rgb = np.random.default_rng(6).uniform(-1, 2, size=(5, 6, 3))
    np.testing.assert_array_equal(TC.apply_colormap(rgb),
                                  JC.apply_colormap(rgb))


def test_pca_matches_sklearn():
    from sklearn.decomposition import PCA
    rng = np.random.default_rng(7)
    flat = rng.normal(size=(600, 12)) @ rng.normal(size=(12, 12))
    want = PCA(n_components=3).fit_transform(flat)
    got = TC.pca3(torch.from_numpy(flat)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    img = (flat.reshape(20, 30, 12) * 0.1).astype(np.float32)
    np.testing.assert_allclose(TC.apply_colormap(img), JC.apply_colormap(img),
                               rtol=0, atol=1e-5)
    from langsplat4d.render.driver import pca_compress as j_pca
    from langsplat4d_torch.render.driver import pca_compress as t_pca
    chw = np.ascontiguousarray(img.transpose(2, 0, 1))
    np.testing.assert_allclose(t_pca(chw), j_pca(chw), rtol=0, atol=1e-5)


def _stream_inputs(seed=8, L=3, H=64, W=64, D=16, P=3):
    """Decoded-feature maps [L, H, W, D] with one blob per prompt at each
    level (the levels see the object at different scales), noise
    elsewhere, the prompts' embeddings and GT masks."""
    rng = np.random.default_rng(seed)
    pos = _unit(rng.normal(size=(P, D)))
    neg = _unit(rng.normal(size=(4, D)))
    sem = rng.normal(size=(L, H, W, D)) * 0.6
    masks = {}
    yy, xx = np.mgrid[:H, :W]
    names = [f"obj{k}" for k in range(P)]
    for k in range(P):
        cy, cx = rng.integers(12, H - 12), rng.integers(12, W - 12)
        r = rng.uniform(6, 11)
        masks[names[k]] = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(
            np.uint8)
        for lvl in range(L):
            rr = r * (0.7 + 0.25 * lvl)
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 < rr * rr
            sem[lvl][inside] += pos[k] * (1.5 + 0.5 * lvl)
    return _unit(sem), names, pos, neg, masks


@pytest.mark.parametrize("strategy,adaptive,low", [
    ("point", False, 0), ("mean", False, 0), ("point", True, 0),
    ("mean", True, 0), ("point", True, 1)])
def test_activate_stream_matches_jax(strategy, adaptive, low):
    """IoUs, levels, per-level scores and thresholds as the JAX package's.
    A pixel of the unsmoothed masks may differ only where its normalised
    relevancy is within 1e-5 of that level's threshold: the two packages'
    float32 relevancies differ by rounding, and the adaptive threshold comes
    from a float32 mean summed in another order. None differs here."""
    sem, names, pos, neg, masks = _stream_inputs()
    kw = dict(thresh=0.4, scale=29, chose_mask_strategy=strategy,
              adaptive_thresh=adaptive, adaptive_alpha=0.6 if adaptive
              else None, low_thresh_filter=low)
    j = JE.activate_stream(sem, names, pos, neg, masks, **kw)
    t = TE.activate_stream(torch.from_numpy(sem), names, pos, neg, masks,
                           **kw)
    assert t[1] == j[1]
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-12)
    assert 0 < np.mean(j[0]) < 1
    rel = np.asarray(JR.relevancy_maps(jnp.asarray(sem), jnp.asarray(pos),
                                       jnp.asarray(neg)))
    for k, p in enumerate(names):
        iou_j, lvl_j, score_j, thr_j = j[2][p]
        iou_t, lvl_t, score_t, thr_t = t[2][p]
        assert lvl_t == lvl_j and iou_t == pytest.approx(iou_j, abs=1e-12)
        np.testing.assert_allclose(score_t, score_j, rtol=1e-6)
        np.testing.assert_allclose(thr_t, thr_j, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t[3][p].numpy(), j[3][p].astype(bool))
        mv_t, mv_j = t[4][p][0].numpy(), j[4][p][0].astype(bool)
        lvl = lvl_j
        r = rel[lvl, k]
        smooth = 0.5 * (np.asarray(JE._avg_pool_same(jnp.asarray(r), 29, 14))
                        + r)
        o = smooth - smooth.min()
        o = np.clip(o / (o.max() + 1e-9) * 2 - 1, 0, 1)
        near = np.abs(o - thr_j[lvl]) <= 1e-5
        assert not np.any((mv_t != mv_j) & ~near)


def test_activate_stream_writes_the_pictures(tmp_path):
    sem, names, pos, neg, masks = _stream_inputs(seed=9, H=32, W=40)
    img = np.random.default_rng(9).uniform(size=(32, 40, 3)).astype(
        np.float32)
    TE.activate_stream(torch.from_numpy(sem), names, pos, neg, masks,
                       image=img, image_name=tmp_path / "00001",
                       visualize_results=True)
    base = tmp_path / "00001"
    for sub in ("heatmap/obj0_0", "heatmap/obj1_2", "composited/obj0_1",
                "background/obj2_0", "annotation/obj1_0", "chosen_obj0",
                "chosen_for_video_obj2"):
        assert (base / f"{sub}.png").exists(), sub
    from langsplat4d_torch.data.png import read_png
    heat = read_png(str(base / "heatmap" / "obj0_0.png"))
    assert heat.shape == (32, 40, 3)


def test_video_helpers_match_jax():
    rng = np.random.default_rng(10)
    feats = rng.normal(size=(20, 24, 6)).astype(np.float32)
    mask = (rng.uniform(size=(20, 24)) > 0.6).astype(np.uint8)
    q = rng.normal(size=32).astype(np.float32)
    w = rng.normal(size=(6, 32)).astype(np.float32)

    def j_dec(x):
        return jnp.tanh(x @ w)

    def t_dec(x):
        return torch.tanh(x @ torch.from_numpy(w))
    want = JE.cal_avg_video_feature(j_dec, mask, feats, q)
    got = TE.cal_avg_video_feature(t_dec, torch.from_numpy(mask), feats, q)
    assert got == pytest.approx(want, abs=1e-6)
    assert TE.cal_avg_video_feature(t_dec, torch.zeros(20, 24), feats,
                                     q) == 0.0
    sims = [(i, float(s), float(u)) for i, (s, u) in enumerate(
        rng.uniform(size=(12, 2)))]
    gt = [(2, 4), (8, 9)]
    for thr in (0.3, 0.5, 0.9):
        assert TE.evaluate_video_feature(sims, gt, thr) == \
            JE.evaluate_video_feature(sims, gt, thr)
    for frames, coff in ((1, [0.1, 0.8, 0.1]), (2, [0.1, 0.2, 0.4, 0.2,
                                                    0.1])):
        assert TE.smooth_similarity(sims, frames, coff) == \
            JE.smooth_similarity(sims, frames, coff)


def test_plot_helpers_import_matplotlib_when_called(tmp_path):
    TE.save_similarity_plot([(0, 0.5, 0.1), (1, 0.7, 0.2)],
                            str(tmp_path / "sim.png"), 0.6)
    TE.plot_confusion_matrix([True, False, True], [True, True, False],
                             [False, True], "t", str(tmp_path))
    assert (tmp_path / "sim.png").exists()
    assert (tmp_path / "t_Confusion_matrix.png").exists()


def test_coco_annotations_match_jax(tmp_path):
    """The same COCO file parsed by both packages: masks (from contours of
    seeded blobs), boxes, ids and the frame-index map."""
    import json
    rng = np.random.default_rng(11)
    h, w = 40, 56
    images, anns = [], []
    for i in range(3):
        images.append({"id": i, "file_name": f"{3 * i + 1:05d}_png.rf.{i}.jpg",
                       "height": h, "width": w})
        for cat in (1, 2):
            cnts, _ = cv2.findContours(_blob_mask(rng, h, w, n=2),
                                       cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
            for c in cnts:
                if len(c) < 3:
                    continue
                x, y, bw, bh = cv2.boundingRect(c)
                anns.append({"id": len(anns), "image_id": i,
                             "category_id": cat,
                             "bbox": [x, y, bw, bh],
                             "segmentation": [c.reshape(-1).tolist()]})
    coco = {"categories": [{"id": 1, "name": "cup"}, {"id": 2, "name": "toy"}],
            "images": images, "annotations": anns}
    with open(tmp_path / "_annotations.coco.json", "w") as f:
        json.dump(coco, f)
    j = JE.load_coco_annotations(str(tmp_path), None, {"toy": ["red toy"]})
    t = TE.load_coco_annotations(str(tmp_path), None, {"toy": ["red toy"]})
    assert t[1:] == j[1:]
    assert j[0].keys() == t[0].keys()
    for idx in j[0]:
        assert sorted(j[0][idx]) == sorted(t[0][idx]) == [
            "cup", "red toy", "toy"]
        for lbl in j[0][idx]:
            np.testing.assert_array_equal(t[0][idx][lbl]["mask"],
                                          j[0][idx][lbl]["mask"])
            np.testing.assert_array_equal(t[0][idx][lbl]["bboxes"],
                                          j[0][idx][lbl]["bboxes"])


def test_visualize_reads_png_frames_and_refuses_jpeg(tmp_path):
    """`--visualize_results` reads the annotated frame through the port's
    codec; a JPEG it does not decode (progressive) raises, naming the file
    (baseline JPEG frames: tests/test_torch_codec.py
    ::test_eval_reads_jpeg_frames_as_cv2); a missing file gives None, as
    the reference's cv2.imread does."""
    from PIL import Image
    from langsplat4d_torch.data.png import png_bytes
    from langsplat4d_torch.eval.__main__ import read_frame
    img = np.random.default_rng(12).integers(0, 256, (6, 7, 3), np.uint8)
    png = tmp_path / "00001_png.rf.0.png"
    png.write_bytes(png_bytes(img))
    np.testing.assert_array_equal(read_frame(str(png)),
                                  (img / 255.0).astype(np.float32))
    jpg = tmp_path / "00002_png.rf.1.jpg"
    Image.fromarray(img).save(jpg, progressive=True)
    with pytest.raises(NotImplementedError, match="00002_png.rf.1.jpg"):
        read_frame(str(jpg))
    assert read_frame(str(tmp_path / "missing.jpg")) is None
