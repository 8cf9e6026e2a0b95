"""scripts/quality_e2e_torch.py, the port's run of scripts/quality_e2e.py's
flow, against the JAX script and its fixture on the CPU.

- The port's structured scene (`utils/synth.make_structured_scene`) is the
  fixture's (tests/scene_fixture.py) byte for byte, at the script's sizes
  and at tests/test_torch_quality_micro.py's.
- The port's border following (`eval/evaluate.external_contours`,
  `bounding_rect`) is cv2's `findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)` and `boundingRect` point for point, on the
  fixture's ball masks and on seeded masks (edges, holes, islands in holes,
  several components, one pixel, one row or column); `polygon_to_mask`
  fills each polygon as `cv2.fillPoly` does; the COCO file the script
  writes is the one the JAX script's lines (:176-199, re-stated here with
  cv2 and PIL) write, byte for byte.
- The config text is the JAX script's at scales 1.0 and 0.1, and loads to
  the same values through both packages; QUALITY_EXTRA_CFG="seed = N"
  reaches the training seed.
- The margin equals the JAX arithmetic (`langsplat4d.ae.model.decode`)
  within 1e-5 on the golden AE checkpoint and seeded renders; the PSNR is
  equal.
- The script's host steps run where jax, flax, langsplat4d, PIL and cv2
  cannot be imported. The whole flow at QUALITY_SCALE=0.01 in such a
  process takes minutes on the CPU: it runs with QUALITY_E2E_TORCH=1.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from langsplat4d_torch.eval.evaluate import (bounding_rect, external_contours,
                                             polygon_to_mask)
from langsplat4d_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_AE = os.path.join(REPO, "tests", "fixtures", "golden_quality",
                         "ae_best_ckpt.pth")
REFUSED = ("jax", "jaxlib", "flax", "langsplat4d", "PIL", "cv2")
# the GPU's host has no TensorBoard either (whose image summaries need PIL)
HOST_LACKS = REFUSED + ("tensorboard",)


def _script():
    spec = importlib.util.spec_from_file_location(
        "quality_e2e_torch", os.path.join(REPO, "scripts",
                                          "quality_e2e_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


Q = _script()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.fixture(scope="module")
def ball_masks(tmp_path_factory):
    """The fixture's 16 ball masks at the script's sizes."""
    from tests.scene_fixture import make_structured_scene
    _, info = make_structured_scene(
        str(tmp_path_factory.mktemp("fixture") / "scene"), n_imgs=Q.N_IMGS,
        hw=Q.HW, clip_dim=Q.CLIP_DIM)
    return info


@pytest.mark.parametrize("kw", [
    dict(n_imgs=16, hw=64, clip_dim=16),
    dict(n_imgs=8, hw=48, clip_dim=3, n_obj_points=400, n_bg_points=600)],
    ids=["script", "micro"])
def test_structured_scene_is_the_fixtures(kw, tmp_path):
    from tests.scene_fixture import make_structured_scene
    a, want = make_structured_scene(str(tmp_path / "fixture"), **kw)
    b, got = synth.make_structured_scene(str(tmp_path / "port"), **kw)
    names = _files(a)
    assert names == _files(b) and len(names) == 4 + 4 * kw["n_imgs"]
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    assert np.array_equal(got["f_obj"], want["f_obj"])
    assert np.array_equal(got["f_bg"], want["f_bg"])
    assert got["clip_dim"] == want["clip_dim"]
    assert sorted(got["masks"]) == sorted(want["masks"])
    for i, m in want["masks"].items():
        assert got["masks"][i].dtype == m.dtype
        assert np.array_equal(got["masks"][i], m)


def seeded_masks(hw=48):
    """Seeded uint8 masks of hw x hw, by name: discs and boxes cut by the
    image's edges, rings (holes), a ring with an island in its hole,
    several components, lone pixels, one row, one column, a diagonal line,
    a checkerboard of components touching at corners, and noise."""
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:hw, 0:hw]
    out = {}

    def disc(cy, cx, r):
        return (yy - cy) ** 2 + (xx - cx) ** 2 < r * r

    for k in range(4):
        cy, cx = rng.uniform(-4, hw + 4, 2)
        out[f"disc_{k}"] = disc(cy, cx, rng.uniform(6, 20))
    out["edge_box"] = (yy < 10) | (xx >= hw - 3)
    out["full"] = np.ones((hw, hw), bool)
    for k in range(3):
        cy, cx = rng.uniform(12, hw - 12, 2)
        r = rng.uniform(8, 12)
        out[f"ring_{k}"] = disc(cy, cx, r) & ~disc(cy, cx, r * rng.uniform(
            0.3, 0.7))
    island = disc(24, 24, 18) & ~disc(24, 24, 12)
    out["island_in_hole"] = island | disc(24, 24, 5)
    out["nested_boxes"] = ((abs(yy - 24) <= 20) & (abs(xx - 24) <= 20)
                           & ~((abs(yy - 24) <= 15) & (abs(xx - 24) <= 15))
                           | (abs(yy - 24) <= 8) & (abs(xx - 24) <= 8)
                           & ~((abs(yy - 24) <= 4) & (abs(xx - 24) <= 4))
                           | (yy == 24) & (xx == 24))
    for k in range(3):
        m = np.zeros((hw, hw), bool)
        for _ in range(rng.integers(3, 7)):
            y0, x0 = rng.integers(0, hw, 2)
            m[y0:y0 + rng.integers(1, 12), x0:x0 + rng.integers(1, 12)] = True
        out[f"components_{k}"] = m
    m = np.zeros((hw, hw), bool)
    m[rng.integers(0, hw, 6), rng.integers(0, hw, 6)] = True
    m[0, 0] = m[hw - 1, hw - 1] = True
    out["lone_pixels"] = m
    out["one_row"] = (yy == 17) & (xx > 3) & (xx < hw - 9)
    out["one_column"] = (xx == hw - 1) & (yy > 5)
    out["diagonal"] = (yy == xx) | (yy == hw - 1 - xx) & (xx < 20)
    out["checker"] = ((yy // 4 + xx // 4) % 2 == 0) & (yy < 24)
    out["thin_cross"] = (yy == 30) | (xx == 11)
    for k in range(3):
        out[f"noise_{k}"] = rng.uniform(size=(hw, hw)) < (0.2, 0.5, 0.8)[k]
    return {k: v.astype(np.uint8) for k, v in out.items()}


SEEDED = seeded_masks()


def _hold_contours(mask):
    import cv2
    want, _ = cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    got = external_contours(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert g.tolist() == w.reshape(-1, 2).tolist()
        assert bounding_rect(g) == tuple(cv2.boundingRect(w))
        if len(g) >= 3:
            fill = np.zeros(mask.shape, np.uint8)
            cv2.fillPoly(fill, [w.reshape(-1, 2)], 1)
            pts = g.astype(float).tolist()
            assert np.array_equal(polygon_to_mask(mask.shape, pts), fill)
    return len(got)


def test_contours_of_the_ball_masks_are_cv2s(ball_masks):
    counts = [_hold_contours(m) for m in ball_masks["masks"].values()]
    assert len(counts) == 16 and min(counts) >= 1


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_contours_of_seeded_masks_are_cv2s(name):
    assert _hold_contours(SEEDED[name]) >= 1


def _cv2_coco(masks, frames, hw, ann_dir):
    """scripts/quality_e2e.py:176-199, with its cv2 and PIL."""
    import cv2
    from PIL import Image
    images, annotations = [], []
    for k, fi in enumerate(frames):
        mask = masks[fi]
        name = f"{fi + 1:05d}_png.rf.q{k}.jpg"
        Image.fromarray(np.zeros((hw, hw, 3), np.uint8)).save(
            os.path.join(ann_dir, name))
        images.append({"id": k, "file_name": name, "height": hw, "width": hw})
        cnts, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
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
    coco = {"categories": [{"id": 1, "name": "ball"}],
            "images": images, "annotations": annotations}
    with open(os.path.join(ann_dir, "_annotations.coco.json"), "w") as f:
        json.dump(coco, f)


@pytest.mark.parametrize("which", ["ball", "seeded"])
def test_coco_file_is_the_jax_scripts(which, ball_masks, tmp_path):
    from PIL import Image
    if which == "ball":
        masks, frames, hw = ball_masks["masks"], Q.EVAL_FRAMES, Q.HW
    else:
        masks = dict(enumerate(SEEDED[k] for k in sorted(SEEDED)))
        frames, hw = sorted(masks), 48
    (tmp_path / "cv2").mkdir()
    _cv2_coco(masks, frames, hw, str(tmp_path / "cv2"))
    Q.annotate(str(tmp_path / "port"), masks, frames, hw)
    names = sorted(os.listdir(tmp_path / "cv2"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    with open(tmp_path / "cv2" / "_annotations.coco.json", "rb") as f:
        want = f.read()
    with open(tmp_path / "port" / "_annotations.coco.json", "rb") as f:
        assert f.read() == want
    assert len(json.loads(want)["annotations"]) >= len(frames)
    for n in names:
        if n.endswith(".jpg"):
            a = np.asarray(Image.open(tmp_path / "cv2" / n))
            b = np.asarray(Image.open(tmp_path / "port" / n))
            assert a.shape == b.shape == (hw, hw, 3)
            assert np.array_equal(a, b)


def _jax_config_text(its, scale):
    """The f-string that scripts/quality_e2e.py writes as its config,
    evaluated with the script's names."""
    with open(os.path.join(REPO, "scripts", "quality_e2e.py")) as f:
        tree = ast.parse(f.read())
    texts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "write" and node.args
             and isinstance(node.args[0], ast.JoinedStr)]
    assert len(texts) == 1
    return eval(compile(ast.Expression(texts[0]), "quality_e2e.py", "eval"),
                {"its": its, "scale": scale, "os": os})


@pytest.mark.parametrize("scale,extra", [(1.0, ""), (0.1, ""),
                                         (1.0, "seed = 7")])
def test_config_is_the_jax_scripts(scale, extra, monkeypatch, tmp_path):
    import dataclasses
    from langsplat4d import config as J
    from langsplat4d_torch import config as T
    monkeypatch.setenv("QUALITY_EXTRA_CFG", extra)
    its = Q.stage_iterations(scale)
    assert its == {k: max(int(v * scale), 20) for k, v in
                   dict(cb=1200, cl=300, fb=1500, fl=1200).items()}
    text = Q.config_text(its, scale, extra)
    assert text == _jax_config_text(its, scale)
    path = str(tmp_path / "quality_cfg.py")
    with open(path, "w") as f:
        f.write(text)
    t = T.parse_cli(["--configs", path])
    j = J.parse_cli(["--configs", path])
    for g in ("model", "pipe", "hidden", "optim", "runtime", "extras"):
        assert dataclasses.asdict(getattr(t, g)) == \
            dataclasses.asdict(getattr(j, g)), g
    assert t.optim.fine_base_iterations == its["fb"]
    assert t.extras.seed == (7 if extra else 6666)


def test_margin_and_psnr_are_the_jax_scripts(ball_masks, tmp_path):
    import jax.numpy as jnp
    from langsplat4d.ae.model import decode as ae_decode, load_ckpt
    rng = np.random.default_rng(3)
    renders = tmp_path / "renders_npy"
    renders.mkdir()
    for fi in Q.EVAL_FRAMES:
        r = rng.normal(size=(Q.HW, Q.HW, 3)).astype(np.float32)
        r[ball_masks["masks"][fi] > 0] += 0.8
        np.save(renders / f"{fi:05d}.npy", r)
    got = Q.margin_of(str(renders), ball_masks["masks"], ball_masks["f_obj"],
                      GOLDEN_AE, "cpu")
    # scripts/quality_e2e.py:233-251
    ae_params = load_ckpt(GOLDEN_AE, [8, 3], [8, Q.CLIP_DIM],
                          feature_dim=Q.CLIP_DIM)
    f_obj = ball_masks["f_obj"] / (np.linalg.norm(ball_masks["f_obj"])
                                   + 1e-9)
    margins = []
    for fi in Q.EVAL_FRAMES:
        r = np.load(renders / f"{fi:05d}.npy")
        dec = np.asarray(ae_decode(ae_params, jnp.asarray(r.reshape(-1, 3))))
        dec = dec.reshape(Q.HW, Q.HW, Q.CLIP_DIM)
        dn = dec / (np.linalg.norm(dec, axis=-1, keepdims=True) + 1e-9)
        sim = dn @ f_obj
        m = ball_masks["masks"][fi] > 0
        margins.append(float(sim[m].mean() - sim[~m].mean()))
    want = float(np.mean(margins))
    assert abs(got - want) <= 1e-5 and abs(want) > 0.01, (got, want)

    model = tmp_path / "model"
    for it in (10, 20):
        for sub in ("renders_npy", "gt_npy"):
            (model / "test_rgb" / f"ours_{it}" / sub).mkdir(parents=True)
    base = model / "test_rgb" / "ours_20"
    for i in range(3):
        gt = rng.uniform(size=(Q.HW, Q.HW, 3)).astype(np.float32)
        np.save(base / "gt_npy" / f"{i:05d}.npy", gt)
        np.save(base / "renders_npy" / f"{i:05d}.npy",
                gt + rng.normal(0, 0.05, gt.shape).astype(np.float32))
    psnr, views, it = Q.psnr_of(str(model))
    # scripts/quality_e2e.py:141-161, on the npy ground truth
    psnrs = []
    for i in range(3):
        img = np.load(base / "renders_npy" / f"{i:05d}.npy")
        gt = np.load(base / "gt_npy" / f"{i:05d}.npy")
        mse = np.mean((img[..., :3] - gt[..., :3]) ** 2)
        psnrs.append(-10.0 * np.log10(mse + 1e-12))
    assert (psnr, views, it) == (float(np.mean(psnrs)), 3, 20)


def _refusing(body, refused=REFUSED):
    return textwrap.dedent(f"""
        import sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {refused!r}:
                    raise ImportError("refused: " + name)

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {REPO!r})
    """) + textwrap.dedent(body) + textwrap.dedent(f"""
        bad = sorted(m for m in sys.modules if m.split(".")[0] in {refused!r}
                     or m.startswith(("tests", "scene_fixture")))
        assert not bad, bad
        print("ok")
    """)


def test_host_steps_run_without_jax_pil_or_cv2(tmp_path):
    """The scene, the annotations, the text cache and the config, in a
    process that cannot import jax, flax, langsplat4d, PIL or cv2."""
    code = _refusing(f"""
        import os, runpy
        import numpy as np
        work = {str(tmp_path)!r}
        Q = runpy.run_path({os.path.join(REPO, "scripts",
                                         "quality_e2e_torch.py")!r})
        from langsplat4d_torch.utils.synth import make_structured_scene
        _, info = make_structured_scene(os.path.join(work, "scene"))
        Q["annotate"](os.path.join(work, "annot", "train"), info["masks"])
        Q["text_cache"](os.path.join(work, "text_cache.npz"), info["f_obj"])
        its = Q["stage_iterations"](0.1)
        assert its == dict(cb=120, cl=30, fb=150, fl=120), its
        assert "fine_lang_iterations=120" in Q["config_text"](its, 0.1)
        with open(os.path.join(work, "annot", "train",
                               "_annotations.coco.json")) as f:
            assert len(__import__("json").load(f)["annotations"]) == 3
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def _root_listing():
    """The repo root's entries and their mtimes, bytecode caches apart
    (another test's import may rewrite chip_smoke.py's)."""
    return {n: os.stat(os.path.join(REPO, n)).st_mtime_ns
            for n in os.listdir(REPO) if n != "__pycache__"}


@pytest.mark.skipif(not os.getenv("QUALITY_E2E_TORCH"),
                    reason="the whole flow takes minutes on the CPU; set "
                           "QUALITY_E2E_TORCH=1 to run it")
def test_the_flow_end_to_end_without_jax_pil_or_cv2(tmp_path):
    """scripts/quality_e2e_torch.py at QUALITY_SCALE=0.01 (every stage at
    20 iterations) with --device cpu, in a process that cannot import jax,
    flax, langsplat4d, PIL, cv2 or tensorboard: metrics.json holds every key of the JAX
    script's metrics, with finite numbers, and the repo's root is
    untouched."""
    before = _root_listing()
    work = str(tmp_path / "work")
    code = _refusing(f"""
        import runpy
        sys.argv = ["quality_e2e_torch.py", {work!r}, "--device", "cpu"]
        try:
            runpy.run_path({os.path.join(REPO, "scripts",
                                         "quality_e2e_torch.py")!r},
                           run_name="__main__")
        except SystemExit as e:             # the full-scale floors
            assert str(e).startswith("QUALITY GATE FAILED"), e
    """, HOST_LACKS)
    env = dict(os.environ, QUALITY_SCALE="0.01", QUALITY_EXTRA_CFG="")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    with open(os.path.join(work, "metrics.json")) as f:
        metrics = json.load(f)
    keys = {"scene", "train_iterations", "quality_scale", "psnr_db", "miou",
            "lang_margin", "platform", "timestamp"}
    assert keys <= set(metrics) and metrics["device"] == "cpu"
    assert metrics["train_iterations"] == dict(
        coarse_base=20, coarse_lang=20, fine_base=20, fine_lang=20)
    for k in ("psnr_db", "miou", "lang_margin", "quality_scale"):
        assert np.isfinite(metrics[k]), k
    after = _root_listing()
    assert sorted(n for n in before.keys() | after.keys()
                  if before.get(n) != after.get(n)) == []


def test_gate_is_the_jax_scripts():
    """The floors' failures, worded as scripts/quality_e2e.py:282-289 words
    them."""
    assert Q.gate(dict(psnr=27.0, miou=0.78, margin=0.1), 27.0, 0.78,
                  0.1) == []
    assert Q.gate(dict(psnr=26.994, miou=None, margin=0.09994), 27.0, 0.78,
                  0.1) == ["PSNR 26.99 dB < floor 27.0",
                           "mIoU None < floor 0.78",
                           "lang margin 0.0999 < floor 0.1"]
    assert Q.gate(dict(psnr=30.0, miou=0.5, margin=0.8), 19.5, 0.0,
                  0.03) == []
