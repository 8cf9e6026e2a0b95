#!/usr/bin/env python
"""End-to-end quality measurement through the PyTorch/CUDA port
(langsplat4d_torch) on the structured moving-ball scene: the flow of
scripts/quality_e2e.py with the port's CLIs.

    python scripts/quality_e2e_torch.py [workdir] [--device DEV]

The structured scene (`langsplat4d_torch.utils.synth.make_structured_scene`,
16 views of 64x64, 16-d "CLIP" features) -> AE train and export
(language_features_dim3) -> the four-stage curriculum -> rgb and lang
renders -> eval (Mean IoU on COCO polygons of the known ball masks, a
seeded text-embedding cache) -> PSNR on the test split and the language
margin (mean relevancy to the ball's feature inside its mask minus outside,
the lang renders decoded by the AE). Each CLI runs through its `main(argv)`
in this process, with the reference script's argv; `--device` is passed on
to every CLI where it is given, and without it everything runs on the GPU.

The reference script's environment holds: QUALITY_SCALE scales the stage
budgets (1200/300/1500/1200, each at least 20), QUALITY_EXTRA_CFG is
appended to the config file (e.g. "seed = 7" sets the training seed), and
QUALITY_PSNR_FLOOR / QUALITY_MIOU_FLOOR / QUALITY_MARGIN_FLOOR (27.0, 0.78,
0.1) are the floors: below one, the script exits non-zero. Steps whose
output exists in the work directory are skipped, as there. The metrics go
to <workdir>/metrics.json only; the reference's GOLDEN_EXPORT is not
ported (the golden fixture belongs to the JAX package).
"""
import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N_IMGS, HW, CLIP_DIM = 16, 64, 16
EVAL_FRAMES = (2, 7, 12)
STAGE_BUDGETS = dict(cb=1200, cl=300, fb=1500, fl=1200)


def stage_iterations(scale):
    """{cb, cl, fb, fl}: the stage budgets at `scale`, each at least 20."""
    return {k: max(int(v * scale), 20) for k, v in STAGE_BUDGETS.items()}


def config_text(its, scale, extra=""):
    """The training config file, as the reference script writes it."""
    return f"""
capacity_granule = 4096
tile_capacity = 256
# plane_reg: the time-axis regularizers every reference preset configures
# (dead upstream behind the `stage == "fine"` guard, train.py:331). With 4
# train frames over 8 time cells, an unregularized time axis lets the
# optimizer collapse the moving object inside a sparsely-supervised cell
# (observed: one train view at 21.6 dB vs 38 dB siblings, flat across the
# whole cell). Smoothing ties neighboring cells together.
plane_reg = True
ModelHiddenParams = dict(
    kplanes_out_dim=8, kplanes_resolution=[32, 32, 32, 8], multires=[1, 2],
    net_width=64, defor_depth=1, no_do=False, no_ds=False,
    time_smoothness_weight=0.01, l1_time_planes=0.0001,
    plane_tv_weight=0.0001,
)
OptimizationParams = dict(
    coarse_base_iterations={its['cb']}, coarse_lang_iterations={its['cl']},
    fine_base_iterations={its['fb']}, fine_lang_iterations={its['fl']},
    densify_from_iter={max(int(300 * scale), 5)},
    densify_until_iter={max(int(2000 * scale), 10)},
    densification_interval={max(int(200 * scale), 5)},
    pruning_from_iter=99999,
    opacity_reset_interval=99999, max_points=20000, batch_size=1,
)
{extra}
"""


def annotate(ann_dir, masks, frames=EVAL_FRAMES, hw=HW):
    """The eval's COCO annotations of the ball: for each of `frames`, a
    black placeholder JPEG (only its size is read) and every outer contour
    of its mask with 3 points or more, as a polygon with its bounding box
    (the reference's cv2.findContours / cv2.boundingRect, by the port's
    border following), in `ann_dir`/_annotations.coco.json."""
    from langsplat4d_torch.data.jpeg import write_jpeg
    from langsplat4d_torch.eval.evaluate import (bounding_rect,
                                                 external_contours)
    os.makedirs(ann_dir, exist_ok=True)
    images, annotations = [], []
    for k, fi in enumerate(frames):
        name = f"{fi + 1:05d}_png.rf.q{k}.jpg"
        write_jpeg(os.path.join(ann_dir, name), np.zeros((hw, hw, 3),
                                                         np.uint8))
        images.append({"id": k, "file_name": name, "height": hw, "width": hw})
        for c in external_contours(masks[fi]):
            seg = c.astype(float).reshape(-1).tolist()
            if len(seg) < 6:
                continue
            x, y, w, h = bounding_rect(c)
            annotations.append({
                "id": len(annotations), "image_id": k, "category_id": 1,
                "bbox": [float(x), float(y), float(w), float(h)],
                "segmentation": [seg]})
    coco = {"categories": [{"id": 1, "name": "ball"}],
            "images": images, "annotations": annotations}
    with open(os.path.join(ann_dir, "_annotations.coco.json"), "w") as f:
        json.dump(coco, f)


def text_cache(path, f_obj, clip_dim=CLIP_DIM):
    """The eval's text embeddings: "ball" is the ball's feature, four seeded
    unit vectors the negatives."""
    rng = np.random.default_rng(7)
    negs = rng.normal(size=(4, clip_dim)).astype(np.float32)
    negs /= np.linalg.norm(negs, axis=-1, keepdims=True)
    np.savez(path, ball=f_obj, object=negs[0], things=negs[1],
             stuff=negs[2], texture=negs[3])


def psnr_of(model):
    """Mean PSNR of the last test_rgb/ours_* renders against their ground
    truth -> (psnr, views, the iteration of that directory)."""
    base = sorted(glob.glob(os.path.join(model, "test_rgb", "ours_*")))[-1]
    renders = sorted(glob.glob(os.path.join(base, "renders_npy", "*.npy")))
    gts = sorted(glob.glob(os.path.join(base, "gt_npy", "*.npy")))
    if not renders or len(gts) != len(renders):
        raise SystemExit(f"{base}: {len(renders)} renders and {len(gts)} "
                         "ground truths")
    psnrs = []
    for rp, gp in zip(renders, gts):
        img, gt = np.load(rp), np.load(gp)
        mse = np.mean((img[..., :3] - gt[..., :3]) ** 2)
        psnrs.append(-10.0 * np.log10(mse + 1e-12))
    return float(np.mean(psnrs)), len(psnrs), int(base.split("_")[-1])


def margin_of(renders, masks, f_obj, ae_ckpt, device, frames=EVAL_FRAMES,
              hw=HW, clip_dim=CLIP_DIM):
    """The language margin: the lang renders of `frames` decoded by the AE,
    their cosine relevancy to the ball's feature, mean inside the ball's
    mask minus mean outside, averaged over the frames."""
    from langsplat4d_torch.ae.model import load_ckpt
    from langsplat4d_torch.core.device import fp32_matmul
    ae = load_ckpt(ae_ckpt, [8, 3], [8, clip_dim], clip_dim, device=device)
    f_obj = f_obj / (np.linalg.norm(f_obj) + 1e-9)
    margins = []
    for fi in frames:
        r = np.load(os.path.join(renders, f"{fi:05d}.npy"))      # [H, W, 3]
        with torch.no_grad(), fp32_matmul():
            dec = ae.decode(torch.from_numpy(r.reshape(-1, 3)).to(
                device)).cpu().numpy()
        dec = dec.reshape(hw, hw, clip_dim)
        dn = dec / (np.linalg.norm(dec, axis=-1, keepdims=True) + 1e-9)
        sim = dn @ f_obj
        m = masks[fi] > 0
        margins.append(float(sim[m].mean() - sim[~m].mean()))
    return float(np.mean(margins))


@contextlib.contextmanager
def stage_clock(stages, device):
    """While entered, (stage, iterations, seconds) of every curriculum stage
    the loop runs goes to `stages`."""
    from langsplat4d_torch.train import loop
    fn = loop.scene_reconstruction

    def timed(cfg, scene, state, dcfg, stage, joint_train, train_iter, *a,
              **k):
        t0 = time.perf_counter()
        out = fn(cfg, scene, state, dcfg, stage, joint_train, train_iter, *a,
                 **k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stages.append((stage, train_iter, time.perf_counter() - t0))
        return out
    loop.scene_reconstruction = timed
    try:
        yield
    finally:
        loop.scene_reconstruction = fn


def run(work, device=None, log=print):
    """The flow in `work` -> (the metrics, also written to
    `work`/metrics.json; {psnr, miou, margin} unrounded, for `gate`).
    `device`: the torch device the CLIs get through --device; None passes
    no flag (the GPU)."""
    from langsplat4d_torch.ae import test as ae_test
    from langsplat4d_torch.ae import train as ae_train
    from langsplat4d_torch.config import load_py_config
    from langsplat4d_torch.core.device import resolve_device
    from langsplat4d_torch.eval import __main__ as eval_cli
    from langsplat4d_torch.render import __main__ as render_cli
    from langsplat4d_torch.train import __main__ as train_cli
    from langsplat4d_torch.utils.synth import make_structured_scene
    dev = resolve_device(device)
    dev_flag = ["--device", str(device)] if device is not None else []
    work = os.path.abspath(work)
    os.makedirs(work, exist_ok=True)
    scene = os.path.join(work, "scene")
    model = os.path.join(work, "model")
    ae_ckpt = os.path.join(work, "ae", "quality", "best_ckpt.pth")
    seconds = {}

    def step(name, fn, argv):
        log(f"+ {name} {' '.join(argv)}")
        t0 = time.perf_counter()
        out = fn(argv + dev_flag)
        seconds[name] = time.perf_counter() - t0
        log(f"  ok ({seconds[name]:.0f}s)")
        return out

    if not os.path.exists(os.path.join(scene, "dataset.json")):
        _, info = make_structured_scene(scene, n_imgs=N_IMGS, hw=HW,
                                        clip_dim=CLIP_DIM)
        np.savez(os.path.join(work, "scene_info.npz"),
                 f_obj=info["f_obj"], f_bg=info["f_bg"],
                 **{f"mask_{i}": m for i, m in info["masks"].items()})
    info = np.load(os.path.join(work, "scene_info.npz"))
    masks = {i: info[f"mask_{i}"] for i in range(N_IMGS)}

    # 1. AE: train on the raw clip-space features, export language_features_dim3
    ae_args = ["--dataset_path", scene, "--model_name", "quality",
               "--encoder_dims", "8", "3", "--decoder_dims", "8",
               str(CLIP_DIM), "--feature_dims", str(CLIP_DIM),
               "--ckpt_dir", os.path.join(work, "ae")]
    if not os.path.exists(ae_ckpt):
        step("ae.train", ae_train.main,
             ae_args + ["--num_epochs", "300", "--lr", "1e-2"])
    if not os.path.exists(os.path.join(scene, "language_features_dim3")):
        step("ae.test", ae_test.main, ae_args)

    # 2. the four-stage curriculum
    scale = float(os.getenv("QUALITY_SCALE", "1.0"))
    its = stage_iterations(scale)
    cfgp = os.path.join(work, "quality_cfg.py")
    with open(cfgp, "w") as f:
        f.write(config_text(its, scale, os.getenv("QUALITY_EXTRA_CFG", "")))
    stages = []
    if not os.path.exists(os.path.join(model, "point_cloud",
                                       f"fine-lang_iteration_{its['fl']}")):
        with stage_clock(stages, dev):
            step("train", train_cli.main, [
                "--source_path", scene, "--model_path", model,
                "--language_features_name", "language_features_dim3",
                "--feature_level", "1", "--expname", "quality", "--configs",
                cfgp, "--port", "-1", "--save_iterations", str(its['fl']),
                "--checkpoint_iterations", str(its['fl']),
                "--test_iterations", str(its['fl'])])
    for stage, n_it, secs in stages:
        log(f"  {stage}: {n_it} iterations in {secs:.2f} s, "
            f"{n_it / secs:.3f} it/s")

    # 3. render rgb (PSNR) and lang (the eval's input)
    common = ["--model_path", model, "--source_path", scene,
              "--language_features_name", "language_features_dim3",
              "--feature_level", "1", "--configs", cfgp,
              "--load_stage", "fine-lang", "--novideo", "1"]
    step("render rgb", render_cli.main, common + ["--mode", "rgb",
                                                  "--skip_video"])
    step("render lang", render_cli.main, common + ["--mode", "lang",
                                                   "--skip_train"])
    psnr, views, iters = psnr_of(model)
    log(f"PSNR (test split, {views} views): {psnr:.2f} dB")

    # 4. eval: annotations from the known masks, the text cache
    exps = os.path.join(work, "exps")
    for level in (1, 2, 3):
        d = os.path.join(exps, f"quality_{level}", "video_lang")
        os.makedirs(d, exist_ok=True)
        tgt = os.path.join(d, f"ours_{iters}")
        if not os.path.exists(tgt):
            os.symlink(os.path.join(model, "video_lang", f"ours_{iters}"),
                       tgt)
    annotate(os.path.join(work, "annot", "train"), masks)
    cache_path = os.path.join(work, "text_cache.npz")
    text_cache(cache_path, info["f_obj"])
    miou = step("eval", eval_cli.main, [
        "--exp_name", "quality", "--iterations", str(iters),
        "--annotation_folder", os.path.join(work, "annot"),
        "--ae_ckpt_path", ae_ckpt, "--encoder_hidden_dims", "8", "3",
        "--decoder_hidden_dims", "8", str(CLIP_DIM), "--feat_dim", "3",
        "--dataset_type", "hypernerf", "--feat_root", exps, "--output_path",
        os.path.join(work, "eval_out"), "--text_embedding_cache",
        cache_path])
    log(f"mIoU: {miou}")

    lang_margin = margin_of(
        os.path.join(model, "video_lang", f"ours_{iters}", "renders_npy"),
        masks, info["f_obj"], ae_ckpt, dev)
    log(f"lang margin (in-mask minus out-of-mask relevancy): "
        f"{lang_margin:.4f}")

    metrics = {
        "scene": "structured moving-ball fixture "
                 f"({N_IMGS} views, {HW}x{HW}, clip_dim {CLIP_DIM})",
        "train_iterations": {"coarse_base": its['cb'],
                             "coarse_lang": its['cl'],
                             "fine_base": its['fb'], "fine_lang": its['fl']},
        "quality_scale": scale,
        "psnr_db": round(psnr, 2),
        "miou": round(miou, 4) if miou is not None else None,
        "lang_margin": round(lang_margin, 4),
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "seed": load_py_config(cfgp).get("seed", 6666),
        "stage_it_per_s": {stage: n_it / secs for stage, n_it, secs in stages},
        "step_seconds": seconds,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    with open(os.path.join(work, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    log(json.dumps(metrics))
    return metrics, dict(psnr=psnr, miou=miou, margin=lang_margin)


def gate(measured, psnr_floor, miou_floor, margin_floor):
    """The reference script's failures of `run`'s unrounded measurements
    at these floors (empty where every floor holds)."""
    psnr, miou, margin = (measured["psnr"], measured["miou"],
                          measured["margin"])
    failures = []
    if psnr < psnr_floor:
        failures.append(f"PSNR {psnr:.2f} dB < floor {psnr_floor}")
    if miou is None or miou < miou_floor:
        failures.append(f"mIoU {miou} < floor {miou_floor}")
    if margin < margin_floor:
        failures.append(f"lang margin {margin:.4f} < floor {margin_floor}")
    return failures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("work", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "quality_e2e_torch"))
    p.add_argument("--device", default=None,
                   help="torch device for every CLI; the GPU by default")
    args = p.parse_args(argv)
    _, measured = run(args.work, args.device)
    psnr_floor = float(os.getenv("QUALITY_PSNR_FLOOR", 27.0))
    miou_floor = float(os.getenv("QUALITY_MIOU_FLOOR", 0.78))
    margin_floor = float(os.getenv("QUALITY_MARGIN_FLOOR", 0.1))
    failures = gate(measured, psnr_floor, miou_floor, margin_floor)
    if failures:
        raise SystemExit("QUALITY GATE FAILED: " + "; ".join(failures))
    print(f"quality gate passed: PSNR {measured['psnr']:.2f} >= "
          f"{psnr_floor}, mIoU {measured['miou']:.3f} >= {miou_floor}")


if __name__ == "__main__":
    main()
