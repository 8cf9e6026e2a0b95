"""The slice's gate: tests/test_quality_micro.py's scene, configuration and
floors through the port's `training(cfg)` on the CPU.

The structured moving-ball scene (8 views, 48x48, 3-dim language features)
is written to disk, read back by the port's Scene, trained through the four
curriculum stages (about 220 iterations, densification on) and rendered from
a training view. Floors, the repo's own (tests/test_quality_micro.py):
RGB PSNR >= 16 dB, language margin (in-mask minus out-of-mask cosine
relevancy to the object's feature) >= 0.15, and the mean of the last two
drained losses <= 0.6 x the mean of the first two. The losses are captured
through the port's Telemetry.scalars, as there. The JAX run of the same
gate was calibrated at 22.10 dB, margin 0.836, ratio 0.035 in 93 s.
"""
import time

import numpy as np
import pytest
import torch

from tests.scene_fixture import make_structured_scene


@pytest.fixture(scope="module")
def micro_trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_micro_q")
    scene_dir = str(root / "scene")
    _, info = make_structured_scene(scene_dir, n_imgs=8, hw=48, clip_dim=3,
                                    n_obj_points=400, n_bg_points=600)

    from langsplat4d_torch.config import Config
    cfg = Config()
    cfg.model.source_path = scene_dir
    cfg.model.model_path = str(root / "model")
    cfg.model.language_features_name = "language_features"
    cfg.model.feature_level = 1
    cfg.model.white_background = True
    cfg.optim.coarse_base_iterations = 60
    cfg.optim.coarse_lang_iterations = 30
    cfg.optim.fine_base_iterations = 70
    cfg.optim.fine_lang_iterations = 60
    cfg.optim.densify_from_iter = 20
    cfg.optim.densify_until_iter = 100
    cfg.optim.densification_interval = 40
    cfg.optim.pruning_from_iter = 99999
    cfg.optim.opacity_reset_interval = 99999
    cfg.optim.max_points = 4096
    cfg.optim.batch_size = 1
    cfg.runtime.capacity_granule = 1024
    cfg.runtime.tile_capacity = 256
    cfg.extras.save_iterations = []
    cfg.extras.checkpoint_iterations = []
    cfg.extras.test_iterations = []
    cfg.hidden.kplanes_config = {
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 8, "resolution": [16, 16, 16, 4]}
    cfg.hidden.multires = [1]
    cfg.hidden.net_width = 32
    cfg.hidden.defor_depth = 1
    cfg.hidden.no_dlang = 0

    losses = []
    from langsplat4d_torch.train import loop
    from langsplat4d_torch.utils import telemetry as tel

    orig_scalars = tel.Telemetry.scalars

    def capture(self, d, it):
        for k, v in d.items():
            if k.endswith("total_loss"):
                losses.append(float(v))
        return orig_scalars(self, d, it)

    tel.Telemetry.scalars = capture
    t0 = time.perf_counter()
    try:
        state = loop.training(cfg, device="cpu")
    finally:
        tel.Telemetry.scalars = orig_scalars
    return cfg, state, info, losses, time.perf_counter() - t0


def _render_view(cfg, state, view, mode_lang):
    from langsplat4d_torch.field.deformation import (DeformConfig,
                                                     make_grid_spatial_cache)
    from langsplat4d_torch.render.pipeline import render
    from langsplat4d_torch.render.raster import RasterSettings

    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    settings = RasterSettings(
        image_height=view.height, image_width=view.width,
        sh_degree=int(state.active_sh_degree), include_feature=mode_lang)
    gs = state.gaussians()
    bg = torch.ones(3) if cfg.model.white_background else torch.zeros(3)
    with torch.no_grad():
        grid_spatial = make_grid_spatial_cache(state.deform, dcfg,
                                               state.aabb, gs.xyz)
        out = render(settings, dcfg, "fine-lang", view.camera_params("cpu"),
                     view.time, gs, state.deform, state.aabb, bg,
                     grid_spatial=grid_spatial)
    key = "language_feature_image" if mode_lang else "render"
    return out[key].numpy()


def test_micro_train_quality(micro_trained):
    cfg, state, info, losses, seconds = micro_trained

    from langsplat4d_torch.data.scene import Scene
    scene = Scene(cfg.model.source_path, model_path=cfg.model.model_path)
    # the i%4 split: train camera k shows frame 4k, so camera 1 is frame 4
    view = scene.getTrainCameras()[1]

    img = _render_view(cfg, state, view, mode_lang=False).transpose(1, 2, 0)
    gt = np.asarray(view.image, np.float32).transpose(1, 2, 0)
    mse = float(np.mean((img[..., :3] - gt[..., :3]) ** 2))
    psnr = -10.0 * np.log10(mse + 1e-12)

    lang = _render_view(cfg, state, view, mode_lang=True).transpose(1, 2, 0)
    f_obj = info["f_obj"] / (np.linalg.norm(info["f_obj"]) + 1e-9)
    ln = lang / (np.linalg.norm(lang, axis=-1, keepdims=True) + 1e-9)
    sim = ln @ f_obj
    m = info["masks"][4] > 0
    margin = float(sim[m].mean() - sim[~m].mean())

    assert len(losses) >= 4
    head = float(np.mean(losses[:2]))
    tail = float(np.mean(losses[-2:]))
    print(f"\nport micro gate: PSNR {psnr:.2f} dB, lang margin {margin:.4f}, "
          f"loss head {head:.4f} -> tail {tail:.4f} (ratio "
          f"{tail / head:.3f}), training {seconds:.1f} s, "
          f"{state.num_active} Gaussians")
    assert psnr >= 16.0, f"micro-train PSNR {psnr:.2f} dB below floor"
    assert margin >= 0.15, f"language margin {margin:.4f} below floor"
    assert tail <= 0.6 * head, (
        f"loss did not decrease: head {head:.4f} -> tail {tail:.4f}")
