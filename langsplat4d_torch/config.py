"""Unified typed configuration (a copy of langsplat4d/config.py: the port
imports nothing of the JAX package, so it keeps its own).

The reference spreads configuration over three layers (SURVEY §2.9):
argparse groups (`arguments/__init__.py:47-165`), mmcv python config files with
`_base_` inheritance (`train.py:593-597`), and ~20 env-var knobs (e.g.
`language_feature_hiddendim`, `centers_num`, `use_discrete_lang_f`). Here they
collapse into dataclasses; env vars are honored as *defaults* for parity with
existing scripts, but everything is a first-class field. The presets under
`configs/` load unchanged. Fields that only the JAX package reads (the TPU
render tile, the mesh axes, orbax checkpoints, the packed-step switch) are kept
so that the same presets and `cfg_args` files load in both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _env(name: str, default, cast=None):
    v = os.getenv(name)
    if v is None:
        return default
    if cast is bool:
        return v in ("t", "true", "1", "True")
    return (cast or type(default))(v)


def _env_flag(name: str) -> bool:
    return os.getenv(name, "f") == "t"


@dataclass
class ModelConfig:
    """Reference ModelParams (arguments/__init__.py:47-74)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    language_features_name: str = "language_features_video_dim3"
    images: str = "images"
    resolution: int = -1
    white_background: bool = True
    feature_level: int = -1
    eval: bool = True
    render_process: bool = False
    add_points: bool = False
    extension: str = ".png"
    llffhold: int = 8

    @property
    def lf_path(self) -> Optional[str]:
        if _env_flag("ONLY_EVAL"):
            return None
        return os.path.join(self.source_path, self.language_features_name)


@dataclass
class PipelineConfig:
    """Reference PipelineParams (arguments/__init__.py:76-81)."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class HiddenConfig:
    """Deformation/HexPlane hyperparams — reference ModelHiddenParams
    (arguments/__init__.py:82-116)."""
    net_width: int = 64
    timebase_pe: int = 4
    defor_depth: int = 1
    posebase_pe: int = 10
    scale_rotation_pe: int = 2
    opacity_pe: int = 2
    timenet_width: int = 64
    timenet_output: int = 32
    bounds: float = 1.6
    plane_tv_weight: float = 0.0001
    time_smoothness_weight: float = 0.01
    l1_time_planes: float = 0.0001
    kplanes_config: Dict[str, Any] = field(default_factory=lambda: {
        "grid_dimensions": 2,
        "input_coordinate_dim": 4,
        "output_coordinate_dim": 32,
        "resolution": [64, 64, 64, 25],
    })
    multires: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    no_dx: bool = False
    no_grid: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    no_dlang: int = 1
    empty_voxel: bool = False
    grid_pe: int = 0
    static_mlp: bool = False
    apply_rotation: bool = False


@dataclass
class OptimizationConfig:
    """Reference OptimizationParams (arguments/__init__.py:118-165)."""
    dataloader: bool = False
    zerostamp_init: bool = False
    custom_sampler: Optional[str] = None
    coarse_base_iterations: int = 3000
    coarse_lang_iterations: int = 1000
    fine_base_iterations: int = 10000
    fine_lang_iterations: int = 10000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20_000
    deformation_lr_init: float = 0.00016
    deformation_lr_final: float = 0.000016
    deformation_lr_delay_mult: float = 0.01
    grid_lr_init: float = 0.0016
    grid_lr_final: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    language_feature_lr: float = 0.0025
    include_feature: bool = True
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0
    lambda_lpips: float = 0
    weight_constraint_init: float = 1
    weight_constraint_after: float = 0.2
    weight_decay_iteration: int = 5000
    opacity_reset_interval: int = 3000
    densification_interval: int = 100
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold_coarse: float = 0.0002
    densify_grad_threshold_fine_init: float = 0.0002
    densify_grad_threshold_after: float = 0.0002
    pruning_from_iter: int = 500
    pruning_interval: int = 100
    opacity_threshold_coarse: float = 0.005
    opacity_threshold_fine_init: float = 0.005
    opacity_threshold_fine_after: float = 0.005
    batch_size: int = 1
    add_point: bool = False
    max_points: int = 360_000           # densify cap (train.py:399)
    min_points_for_prune: int = 200_000  # prune floor (train.py:403)

    @property
    def iterations(self) -> int:
        return (self.coarse_base_iterations + self.coarse_lang_iterations
                + self.fine_base_iterations + self.fine_lang_iterations)


@dataclass
class RuntimeConfig:
    """Collapsed env-var knobs (SURVEY §2.9) and execution options. The same
    fields and defaults as the JAX package's, so presets and `cfg_args` files
    load alike; the port reads the ones its modules name."""
    language_feature_hiddendim: int = field(
        default_factory=lambda: _env("language_feature_hiddendim", 3, int))
    centers_num: int = field(default_factory=lambda: _env("centers_num", 3, int))
    use_discrete_lang_f: bool = field(
        default_factory=lambda: _env_flag("use_discrete_lang_f"))
    nonormalized: bool = field(default_factory=lambda: _env_flag("nonormalized"))
    no_resnet: bool = field(default_factory=lambda: _env_flag("no_resnet"))
    use_tribute_dlang: bool = field(
        default_factory=lambda: _env_flag("use_tribute_dlang"))
    addcosloss: bool = field(default_factory=lambda: _env_flag("addcosloss"))
    only_eval: bool = field(default_factory=lambda: _env_flag("ONLY_EVAL"))
    exps_dir: str = field(default_factory=lambda: os.getenv("ExpsDir", "./output"))
    wandb: bool = field(default_factory=lambda: _env_flag("wandb"))
    tile_size: int = 16          # rasterizer pixel tile edge (training)
    tile_capacity: int = 1024    # max Gaussians composited per tile list
    render_tile_size: int = field(  # pixel tile edge of the render path
        default_factory=lambda: _env("LS4D_RENDER_TILE", 32, int))
    capacity_granule: int = 8192  # Gaussian-count padding granule
    data_parallel: int = 1       # camera-batch data parallelism (JAX mesh)
    gaussian_shards: int = 1     # Gaussian-axis sharding (JAX mesh)
    prefetch_depth: int = 2      # train batches built ahead on a host thread
                                 # (0 = synchronous, the reference's behavior)
    compact_batch: bool = True   # uint8 images and raw (seg-id, feature-
                                 # table) language GT, decoded on the device
                                 # (train/step.py materialize_batch)
    packed_step: bool = field(   # one packed host row per camera (the JAX
        default_factory=lambda: os.getenv("LS4D_PACKED_STEP", "1") != "0")
                                 # package's switch; the port always packs)
    gt_cache_mb: int = 4096      # device-resident GT cache budget
                                 # (data/gt_cache.py); 0 = upload every
                                 # iteration like the reference
    plane_reg: bool = field(     # apply the HexPlane regularizers
        default_factory=lambda: _env_flag("LS4D_PLANE_REG"))
                                 # (time-smoothness / l1-time / plane-TV,
                                 # hidden.* weights) in fine stages. The
                                 # reference's guard `stage == "fine"` never
                                 # matches its stage names (train.py:331), so
                                 # they are dead upstream; default False
                                 # preserves that parity.
    stream_train: bool = field(  # train on the stream layout from the start
        default_factory=lambda: _env_flag("LS4D_STREAM_TRAIN"))
    stream_train_auto: bool = field(  # switch to the stream layout when the
        default_factory=lambda: os.getenv("LS4D_STREAM_TRAIN_AUTO",
                                          "1") != "0")
                                 # tile lists saturate (train/loop.py
                                 # maybe_stream_switch, on the GPU only)
    watchdog_execv: bool = True  # NaN/explosion watchdog re-execs the process
                                 # (train.py:341-351); False raises instead
    orbax_ckpt: bool = field(    # the JAX package's orbax checkpoints; the
        default_factory=lambda: _env_flag("LS4D_ORBAX_CKPT"))
                                 # port always writes torch files


@dataclass
class TrainExtras:
    """Loose top-level train.py flags (train.py:571-590)."""
    ip: str = "127.0.0.1"
    port: int = 6009
    debug_from: int = -1
    detect_anomaly: bool = False
    test_iterations: List[int] = field(default_factory=lambda: [2000, 10000, 20000])
    save_iterations: List[int] = field(default_factory=lambda: [2000, 10000, 20000])
    quiet: bool = False
    checkpoint_iterations: List[int] = field(default_factory=list)
    start_checkpoint: Optional[str] = None
    expname: str = ""
    configs: str = ""
    joint_coarse: bool = False
    joint_fine: bool = False
    lam: float = 0.2
    beta: float = 0.01
    resume_from_final_stage: int = 0
    resume_from_final_stage_load_iter: int = 10000
    init_from_stage: str = "fine-base"
    coff_time_smooth_loss_weight: float = 1e-1
    seed: int = 6666


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipe: PipelineConfig = field(default_factory=PipelineConfig)
    hidden: HiddenConfig = field(default_factory=HiddenConfig)
    optim: OptimizationConfig = field(default_factory=OptimizationConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    extras: TrainExtras = field(default_factory=TrainExtras)


# ---------------------------------------------------------------------------
# Python config-file overlay (mmcv-style `_base_` inheritance, no mmcv dep)
# ---------------------------------------------------------------------------

def load_py_config(path: str) -> Dict[str, Any]:
    """Execute a python config file; `_base_` entries are merged first.

    Mirrors the reference's mmcv `Config.fromfile` overlay
    (utils/params_utils.py:1-9, e.g. arguments/hypernerf/chicken.py:1).
    """
    ns: Dict[str, Any] = {}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), {}, ns)
    merged: Dict[str, Any] = {}
    bases = ns.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    for base in bases:
        base_path = os.path.join(os.path.dirname(path), base)
        _deep_update(merged, load_py_config(base_path))
    _deep_update(merged, ns)
    return merged


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def apply_overrides(cfg: Config, overrides: Dict[str, Any]) -> None:
    """Apply a flat param dict (from a config file or CLI) onto the config.

    Known reference param-group names are routed to the matching sub-config
    (`merge_hparams` semantics, utils/params_utils.py:1-9).
    """
    for group_name in ("ModelParams", "PipelineParams", "ModelHiddenParams",
                       "OptimizationParams"):
        if group_name in overrides:
            for k, v in overrides[group_name].items():
                _set_anywhere(cfg, k, v)
    for k, v in overrides.items():
        if k.endswith("Params"):
            continue
        _set_anywhere(cfg, k, v)


def _set_anywhere(cfg: Config, key: str, value: Any) -> None:
    for sub in (cfg.model, cfg.pipe, cfg.hidden, cfg.optim, cfg.runtime,
                cfg.extras):
        if hasattr(sub, key):
            setattr(sub, key, value)
            return
    # Unknown keys are ignored, as mmcv overlay would ignore unused entries.


# ---------------------------------------------------------------------------
# argparse bridge (CLI parity with the reference train.py/render.py)
# ---------------------------------------------------------------------------

def add_config_args(parser: argparse.ArgumentParser, cfg: Config) -> None:
    seen = set()
    for sub in (cfg.model, cfg.pipe, cfg.hidden, cfg.optim, cfg.extras):
        for f in dataclasses.fields(sub):
            if f.name in seen or f.name in ("kplanes_config", "multires"):
                continue
            seen.add(f.name)
            default = getattr(sub, f.name)
            if isinstance(default, bool):
                parser.add_argument(f"--{f.name}", default=None,
                                    action="store_true")
            elif isinstance(default, list):
                parser.add_argument(f"--{f.name}", nargs="+", type=int,
                                    default=None)
            else:
                typ = type(default) if default is not None else str
                parser.add_argument(f"--{f.name}", type=typ, default=None)


def parse_cli(argv=None, description: str = "",
              strict: bool = False) -> Config:
    cfg = Config()
    parser = argparse.ArgumentParser(description=description)
    add_config_args(parser, cfg)
    if strict:
        args = parser.parse_args(argv)
    else:
        args, _ = parser.parse_known_args(argv)
    ns = {k: v for k, v in vars(args).items() if v is not None}
    if ns.get("configs"):
        apply_overrides(cfg, load_py_config(ns["configs"]))
    apply_overrides(cfg, ns)
    return cfg


def save_cfg_args(cfg: Config, model_path: str) -> None:
    """Persist a `cfg_args` Namespace dump (train.py:476-477) for render/eval."""
    os.makedirs(model_path, exist_ok=True)
    ns = {}
    for sub in (cfg.model, cfg.pipe, cfg.hidden, cfg.optim, cfg.extras):
        ns.update(dataclasses.asdict(sub))
    body = ", ".join(f"{k}={v!r}" for k, v in sorted(ns.items()))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(f"Namespace({body})")


def load_cfg_args(model_path: str, cfg: Config) -> Config:
    """Merge a persisted cfg_args back (arguments/__init__.py:167-187)."""
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return cfg
    with open(path) as f:
        text = f.read().strip()
    inner = text[len("Namespace("):-1]
    ns: Dict[str, Any] = eval(f"dict({inner})", {"__builtins__": {}, "dict": dict})
    apply_overrides(cfg, ns)
    return cfg
