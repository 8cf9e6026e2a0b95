"""The port's Config against the JAX package's: the defaults and every
preset under configs/ load to the same field values, and save_cfg_args ->
load_cfg_args round-trips. Exact equality."""
import dataclasses
import glob
import os

import pytest

from langsplat4d import config as J
from langsplat4d_torch import config as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.py")))
GROUPS = ("model", "pipe", "hidden", "optim", "runtime", "extras")


def _fields(cfg):
    return {g: dataclasses.asdict(getattr(cfg, g)) for g in GROUPS}


def test_defaults_match_jax():
    assert _fields(T.Config()) == _fields(J.Config())
    assert T.Config().optim.iterations == J.Config().optim.iterations


def test_preset_families_present():
    families = {os.path.basename(os.path.dirname(p)) for p in PRESETS}
    assert families == {"dnerf", "dycheck", "hypernerf", "multipleview",
                        "neu3d"}


@pytest.mark.parametrize("path", PRESETS,
                         ids=[os.path.relpath(p, REPO) for p in PRESETS])
def test_preset_loads_as_jax(path):
    t, j = T.Config(), J.Config()
    t_over, j_over = T.load_py_config(path), J.load_py_config(path)
    assert t_over == j_over
    T.apply_overrides(t, t_over)
    J.apply_overrides(j, j_over)
    assert _fields(t) == _fields(j)


def test_cfg_args_round_trip(tmp_path):
    cfg = T.Config()
    T.apply_overrides(cfg, T.load_py_config(
        os.path.join(REPO, "configs", "hypernerf", "default.py")))
    cfg.model.source_path = "/data/scene"
    cfg.optim.coarse_base_iterations = 123
    cfg.extras.test_iterations = [5, 7]
    T.save_cfg_args(cfg, str(tmp_path))
    back = T.load_cfg_args(str(tmp_path), T.Config())
    for g in ("model", "pipe", "hidden", "optim", "extras"):
        assert dataclasses.asdict(getattr(back, g)) == \
            dataclasses.asdict(getattr(cfg, g)), g
    # the JAX package reads the port's file alike, and the port the JAX one's
    assert _fields(J.load_cfg_args(str(tmp_path), J.Config())) == \
        _fields(back)
    J.save_cfg_args(J.load_cfg_args(str(tmp_path), J.Config()),
                    str(tmp_path / "j"))
    assert _fields(T.load_cfg_args(str(tmp_path / "j"), T.Config())) == \
        _fields(back)
