"""The slice as a whole, on the committed golden checkpoint: the port renders
the language maps of the structured-ball scene's video frames through
`render_set` (with the ground-truth maps, as the JAX driver writes them),
decodes them with the golden AE and scores them, against the JAX pipeline
on its own render; and the two eval CLIs on the same renders, annotations,
AE checkpoint and text cache."""
import dataclasses
import json
import os
import re
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.ae import model as JM
from langsplat4d_torch.ae import model as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "golden_quality")
FRAMES = (2, 7, 12)          # the eval frames of scripts/quality_e2e.py
CLIP_DIM = 16
AE_DIMS = (["--encoder_hidden_dims", "8", "3",
            "--decoder_hidden_dims", "8", str(CLIP_DIM)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene, the JAX render (render.py) and the port's (render_set) of
    the video split in lang mode, annotations and a text cache built as
    scripts/quality_e2e.py:165-213 builds them."""
    from scene_fixture import make_structured_scene
    import render as j_render
    from langsplat4d_torch.checkpoint import load_trained_model
    from langsplat4d_torch.config import (Config, apply_overrides,
                                          load_cfg_args, load_py_config)
    from langsplat4d_torch.data.scene import Scene
    from langsplat4d_torch.field.deformation import DeformConfig
    from langsplat4d_torch.render.driver import render_set
    work = tmp_path_factory.mktemp("eval_slice")
    scene_dir = str(work / "scene")
    _, info = make_structured_scene(scene_dir, n_imgs=16, hw=64,
                                    clip_dim=CLIP_DIM)
    # the scene's language_features_dim3, the golden AE's export through
    # the port's ae.test (both drivers read it as the ground truth)
    from langsplat4d_torch.ae import test as t_test
    os.makedirs(work / "ae" / "golden")
    shutil.copy(os.path.join(FIXTURE, "ae_best_ckpt.pth"),
                work / "ae" / "golden" / "best_ckpt.pth")
    t_test.main(["--dataset_path", scene_dir, "--model_name", "golden",
                 "--encoder_dims", "8", "3", "--decoder_dims", "8",
                 str(CLIP_DIM), "--feature_dims", str(CLIP_DIM),
                 "--ckpt_dir", str(work / "ae"), "--device", "cpu"])
    cfg_py = os.path.join(FIXTURE, "quality_cfg.py")
    j_model = str(work / "jax_model")
    shutil.copytree(FIXTURE, j_model)
    j_render.main(["--model_path", j_model, "--source_path", scene_dir,
                   "--language_features_name", "language_features_dim3",
                   "--feature_level", "1", "--configs", cfg_py,
                   "--load_stage", "fine-lang", "--novideo", "1",
                   "--mode", "lang", "--skip_train", "--skip_test"])

    cfg = Config()
    apply_overrides(cfg, load_py_config(cfg_py))
    cfg = load_cfg_args(FIXTURE, cfg)
    t_model = str(work / "port_model")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, source_path=scene_dir, model_path=t_model,
        language_features_name="language_features_dim3", feature_level=1))
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    scene = Scene(scene_dir)
    model, it = load_trained_model(FIXTURE, "fine-lang", -1, dcfg,
                                   aabb=scene.aabb, device="cpu")
    render_set(cfg, model, dcfg, scene, "video", it, scene.getVideoCameras(),
               mode="lang", load_stage="fine-lang", novideo=True)
    dirs = {"jax": os.path.join(j_model, "video_lang", f"ours_{it}"),
            "port": os.path.join(t_model, "video_lang", f"ours_{it}")}

    # annotations from the known ball masks, and the text cache
    ann_dir = work / "annot" / "train"
    ann_dir.mkdir(parents=True)
    images, annotations = [], []
    for k, fi in enumerate(FRAMES):
        name = f"{fi + 1:05d}_png.rf.q{k}.jpg"
        images.append({"id": k, "file_name": name, "height": 64,
                       "width": 64})
        cnts, _ = cv2.findContours(info["masks"][fi], cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        for c in cnts:
            seg = c.reshape(-1, 2).astype(float).reshape(-1).tolist()
            if len(seg) < 6:
                continue
            x, y, w, h = cv2.boundingRect(c)
            annotations.append({
                "id": len(annotations), "image_id": k, "category_id": 1,
                "bbox": [float(x), float(y), float(w), float(h)],
                "segmentation": [seg]})
    with open(ann_dir / "_annotations.coco.json", "w") as f:
        json.dump({"categories": [{"id": 1, "name": "ball"}],
                   "images": images, "annotations": annotations}, f)
    negs = np.random.default_rng(7).normal(size=(4, CLIP_DIM)).astype(
        np.float32)
    negs /= np.linalg.norm(negs, axis=-1, keepdims=True)
    cache = str(work / "text_cache.npz")
    np.savez(cache, ball=info["f_obj"], object=negs[0], things=negs[1],
             stuff=negs[2], texture=negs[3])
    roots = {}
    for who, d in dirs.items():
        root = work / f"exps_{who}"
        for level in (1, 2, 3):
            lvl = root / f"quality_{level}" / "video_lang"
            lvl.mkdir(parents=True)
            os.symlink(d, lvl / f"ours_{it}")
        roots[who] = str(root)
    return dict(work=work, info=info, dirs=dirs, roots=roots, it=it,
                annot=str(work / "annot"), cache=cache)


def _margin(renders_npy, decode, info):
    """In-mask minus out-of-mask cosine to the object's feature, over the
    eval frames (test_golden_quality.py's language margin)."""
    f_obj = info["f_obj"] / (np.linalg.norm(info["f_obj"]) + 1e-9)
    margins = []
    for fi in FRAMES:
        r = np.load(os.path.join(renders_npy, f"{fi:05d}.npy"))
        dec = decode(r.reshape(-1, 3)).reshape(r.shape[0], r.shape[1], -1)
        dn = dec / (np.linalg.norm(dec, axis=-1, keepdims=True) + 1e-9)
        sim = dn @ f_obj
        m = info["masks"][fi] > 0
        margins.append(float(sim[m].mean() - sim[~m].mean()))
    return float(np.mean(margins))


def test_driver_writes_the_ground_truth_language_maps(runs):
    """Lang mode saves each view's ground-truth map (the scene's AE-encoded
    features) raw into gt_npy, as the JAX driver does. (The renders are not
    compared here: render.py on the CPU composites the padded tile lists,
    whose T < 1e-4 stop restarts per chunk, ROADMAP queue 3;
    tests/test_torch_render.py holds the port to the JAX stream path.)"""
    j, t = runs["dirs"]["jax"], runs["dirs"]["port"]
    names = sorted(os.listdir(os.path.join(j, "gt_npy")))
    assert len(names) == 16
    assert sorted(os.listdir(os.path.join(t, "gt_npy"))) == names
    for n in names:
        g = np.load(os.path.join(t, "gt_npy", n))
        assert g.shape == (64, 64, 3) and np.abs(g).max() > 0.5
        np.testing.assert_array_equal(g, np.load(os.path.join(j, "gt_npy",
                                                              n)))
    assert sorted(os.listdir(os.path.join(t, "gt"))) == sorted(
        os.listdir(os.path.join(j, "gt")))


def test_golden_margin_through_the_port(runs):
    """The port's render decoded by the port's AE clears the golden floor,
    max(0.05, 0.5 x the recorded margin), and lies within 0.02 of the JAX
    pipeline's margin on its own render (render.py's CPU path)."""
    with open(os.path.join(FIXTURE, "metrics.json")) as f:
        metrics = json.load(f)
    ckpt = os.path.join(FIXTURE, "ae_best_ckpt.pth")
    ae = TM.load_ckpt(ckpt, [8, 3], [8, CLIP_DIM], CLIP_DIM, device="cpu")
    jp = JM.load_ckpt(ckpt, [8, 3], [8, CLIP_DIM], feature_dim=CLIP_DIM)

    def t_dec(x):
        with torch.no_grad():
            return ae.decode(torch.from_numpy(x)).numpy()

    def j_dec(x):
        return np.asarray(JM.decode(jp, jnp.asarray(x)))
    port = _margin(os.path.join(runs["dirs"]["port"], "renders_npy"), t_dec,
                   runs["info"])
    jax_ = _margin(os.path.join(runs["dirs"]["jax"], "renders_npy"), j_dec,
                   runs["info"])
    print(f"language margin: port {port:.4f}, JAX {jax_:.4f}, recorded "
          f"{metrics['lang_margin']}")
    assert port >= max(0.05, 0.5 * metrics["lang_margin"])
    assert abs(port - jax_) <= 0.02


def _mean_iou(out):
    m = re.findall(r"^Mean IoU: (\S+)$", out, re.M)
    assert len(m) == 1, out[-2000:]
    return float(m[0])


def _evals(runs, root, capsys, tag, extra=()):
    """The JAX CLI and the port's on the renders under `root`: their Mean
    IoU lines."""
    from eval import main as j_eval
    from langsplat4d_torch.eval.__main__ import main as t_eval
    argv = ["--exp_name", "quality", "--iterations", str(runs["it"]),
            "--annotation_folder", runs["annot"],
            "--ae_ckpt_path", os.path.join(FIXTURE, "ae_best_ckpt.pth"),
            *AE_DIMS, "--feat_dim", "3", "--dataset_type", "hypernerf",
            "--feat_root", root, "--text_embedding_cache", runs["cache"],
            *extra]
    out = str(runs["work"] / f"eval_{tag}")
    capsys.readouterr()
    j_eval(argv + ["--output_path", out + "_jax"])
    j = _mean_iou(capsys.readouterr().out)
    got = t_eval(argv + ["--output_path", out + "_port", "--device", "cpu"])
    t = _mean_iou(capsys.readouterr().out)
    assert got == t
    return j, t, out


def test_golden_miou_both_evals_on_both_renders(runs, capsys):
    """The thresholded mIoU is not compared across the two renders (the
    adaptive cut sits on a knife edge, scripts/quality_e2e.py:226-231);
    each render is scored by both eval CLIs, which agree within 1e-4."""
    res = {}
    for who in ("port", "jax"):
        j, t, _ = _evals(runs, runs["roots"][who], capsys, who)
        res[who] = (j, t)
        assert abs(j - t) <= 1e-4, (who, j, t)
        assert 0.0 <= t <= 1.0
    with capsys.disabled():
        print(f"\ngolden mIoU: port eval on the port render "
              f"{res['port'][1]:.4f}, on the JAX render {res['jax'][1]:.4f}; "
              f"JAX eval {res['port'][0]:.4f}, {res['jax'][0]:.4f} "
              f"(metrics.json 0.7847)")


def test_eval_clis_agree_with_adaptive_mean_and_csv(runs, capsys,
                                                    monkeypatch):
    """The reference's env knobs (adaptive_thresh, adaptive_alpha,
    low_thresh_filter, interval) and the `mean` level choice with the CSV:
    both CLIs give the same Mean IoU within 1e-4 and the same table."""
    import csv
    import glob
    monkeypatch.setenv("adaptive_thresh", "t")
    monkeypatch.setenv("adaptive_alpha", "0.5")
    monkeypatch.setenv("low_thresh_filter", "1")
    monkeypatch.setenv("interval", "1")
    j, t, out = _evals(runs, runs["roots"]["port"], capsys, "adaptive",
                       ["--chose_mask_strategy", "mean", "--detail_results"])
    assert abs(j - t) <= 1e-4
    tables = []
    for who in ("jax", "port"):
        path, = glob.glob(os.path.join(out + f"_{who}", "quality", "*",
                                       "time-agnostic_results.csv"))
        with open(path) as f:
            tables.append(list(csv.reader(f)))
    assert tables[0][0] == tables[1][0]
    assert [r[0] for r in tables[0][1:]] == [r[0] for r in tables[1][1:]]
    for rj, rt in zip(tables[0][1:], tables[1][1:]):
        assert float(rt[1]) == pytest.approx(float(rj[1]), abs=1e-4)
        assert rt[2] == rj[2]                  # the chosen levels
