"""Preprocess and SH parity, JAX vs the port, on the same numpy scene.
Tolerance 1e-5 (fp32 rounding in two frameworks); integer tile rects and the
visibility mask must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.core.sh import eval_sh as j_eval_sh
from langsplat4d.render import raster as JR
from langsplat4d_torch.core.sh import eval_sh as t_eval_sh
from langsplat4d_torch.render import raster as TR
from tests.test_raster import make_camera, random_scene

TOL = dict(rtol=1e-5, atol=1e-5)


def torch_camera(jcam):
    return TR.CameraParams(*[torch.from_numpy(np.array(x))
                             for x in (jcam.viewmatrix, jcam.projmatrix,
                                       jcam.campos, jcam.tanfovx,
                                       jcam.tanfovy)])


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(rng, deg):
    sh = rng.normal(size=(200, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = j_eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
    got = t_eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sh_colors,hard_cutoffs,tile_size", [
    (True, True, 16), (False, True, 32), (True, False, 16)])
def test_preprocess(rng, sh_colors, hard_cutoffs, tile_size):
    H, W = 48, 64
    jcam = make_camera(H, W)
    n = 300
    means, scales, quats, opac, colors, _ = random_scene(rng, n=n)
    means[:10, 2] = -6.0              # behind the camera: culled
    scales[10:20] *= 30.0             # large splats spanning many tiles
    shs = rng.normal(0, 0.3, size=(n, 16, 3)).astype(np.float32)
    active = np.arange(n) < n - 7     # padded tail
    kw = dict(sh_degree=3, include_feature=True, tile_size=tile_size,
              hard_cutoffs=hard_cutoffs)
    shs_in, colors_in = (shs, None) if sh_colors else (None, colors)

    def j(x):
        return None if x is None else jnp.asarray(x)

    want = JR.preprocess(JR.RasterSettings(H, W, lang_dim=3, **kw), jcam,
                         j(means),
                         jnp.zeros((n, 2)), j(opac), j(scales), j(quats),
                         j(shs_in), j(colors_in), active=j(active))

    def t(x):
        return None if x is None else torch.from_numpy(x)

    got = TR.preprocess(TR.RasterSettings(H, W, **kw), torch_camera(jcam),
                        t(means), t(opac), t(scales), t(quats), t(shs_in),
                        t(colors_in), active=t(active))
    assert set(got) == set(want)
    assert 0 < int(np.asarray(want["visible"]).sum()) < n
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        if w.dtype == bool or key.startswith("rect"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, err_msg=key, **TOL)
