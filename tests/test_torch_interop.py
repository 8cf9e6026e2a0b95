"""Checkpoint and parameter interop: the port's state dict for JAX
parameters, strict loading of deformation.pth files, and the numpy bench
scene."""
import os

import jax
import numpy as np
import pytest
import torch

from langsplat4d.field.deformation import DeformConfig as JDeformConfig
from langsplat4d.field.deformation import init_deform_params
from langsplat4d.interop import (deform_params_to_torch_state_dict,
                                 save_deformation)
from langsplat4d.utils.synth import realistic_gaussians as j_realistic
from langsplat4d_torch.field.deformation import DeformConfig, DeformNetwork
from langsplat4d_torch.interop import (gaussians_from_numpy, load_deformation,
                                       params_from_jax)
from langsplat4d_torch.utils.synth import realistic_gaussians

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_quality",
                      "point_cloud", "fine-lang_iteration_1200")
SMALL = dict(kplanes_out_dim=8, kplanes_resolution=(6, 6, 6, 4),
             multires=(1, 2), net_width=32)


@pytest.mark.parametrize("extra", [{}, dict(static_mlp=True,
                                            empty_voxel=True)])
def test_params_from_jax_matches_jax_state_dict(extra):
    jcfg = JDeformConfig(**SMALL, **extra)
    params = jax.tree.map(np.asarray,
                          init_deform_params(jax.random.PRNGKey(3), jcfg))
    want = deform_params_to_torch_state_dict(params)
    got = params_from_jax(params, DeformConfig(**SMALL, **extra))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    net = DeformNetwork(DeformConfig(**SMALL, **extra))
    net.load_state_dict(got, strict=True)


def test_golden_deformation_loads_strictly():
    dcfg = DeformConfig(kplanes_resolution=(64, 64, 64, 25), multires=(1, 2))
    net = load_deformation(GOLDEN, dcfg)
    sd = torch.load(os.path.join(GOLDEN, "deformation.pth"),
                    map_location="cpu", weights_only=True)
    assert set(net.state_dict()) == set(sd)
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v), k


def test_jax_written_deformation_with_buffers_loads(tmp_path):
    """save_deformation with a config also writes the positional-encoding
    buffers; the loader takes them as the constants they are."""
    jcfg = JDeformConfig(**SMALL)
    params = init_deform_params(jax.random.PRNGKey(4), jcfg)
    save_deformation(str(tmp_path), params, cfg=jcfg)
    net = load_deformation(str(tmp_path), DeformConfig(**SMALL))
    want = deform_params_to_torch_state_dict(jax.tree.map(np.asarray,
                                                          params))
    for k, v in want.items():
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_realistic_gaussians_match_jax():
    n = 700
    want = j_realistic(n, lang_dim=3, seed=5)
    got = realistic_gaussians(n, lang_dim=3, seed=5)
    assert got.num_active == int(want.num_active) == n
    assert got.capacity == want.capacity
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                 "opacity", "language_feature"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_gaussians_from_numpy_roundtrip():
    want = j_realistic(300, lang_dim=3, seed=1)
    arrays = {k: np.asarray(getattr(want, k)) for k in (
        "xyz", "features_dc", "features_rest", "scaling", "rotation",
        "opacity", "language_feature", "num_active")}
    got = gaussians_from_numpy(arrays)
    assert got.num_active == 300 and got.max_sh_degree == 3
    np.testing.assert_array_equal(got.active_mask().numpy(),
                                  np.asarray(want.active_mask()))
    np.testing.assert_array_equal(got.get_features().numpy(),
                                  np.asarray(want.get_features()))
