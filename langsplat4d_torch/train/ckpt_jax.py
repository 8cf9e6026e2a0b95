"""The JAX package's training checkpoints, read without JAX.

The JAX package saves `chkpnt_{stage}_{iteration}.pth` as one pickle of a
dict of numpy arrays (langsplat4d/train/loop.py save_checkpoint): the
parameters and both Adam moments as pytrees of the Gaussian leaves and the
"deform" subtree (plain nested dicts and lists, no modules), the Adam step,
`num_active`, the five densification buffers, `aabb` and the static
`active_sh_degree`. `load_jax_checkpoint` unpickles it with an unpickler
that builds numpy arrays, dtypes and scalars and refuses every other
class, checks every leaf against the DeformConfig and the fields it
carries from the training config (the SH degree, the language width, the
number of discrete centres), and maps the payload through
`interop.train_state_from_jax`. `checkpoint_format` tells that
layout from the port's own `torch.save` file; the JAX package's orbax
directories are refused (the port reads no orbax).
"""
from __future__ import annotations

import os
import pickle
from types import SimpleNamespace
from typing import Dict, Iterator, Tuple

import numpy as np

from langsplat4d_torch.field.deformation import DeformConfig, DeformNetwork
from langsplat4d_torch.interop import params_from_jax, train_state_from_jax
from langsplat4d_torch.train.trainstate import GAUSSIAN_KEYS

# what a pickled dict of numpy arrays names, under numpy 1's and numpy 2's
# module spellings (protocol 5 rebuilds a contiguous array with
# _frombuffer, any other with _reconstruct)
ALLOWED = frozenset(
    [(f"{core}.{mod}", name) for core in ("numpy.core", "numpy._core")
     for mod, name in (("multiarray", "_reconstruct"),
                       ("multiarray", "scalar"), ("numeric", "_frombuffer"))]
    + [("numpy", "ndarray"), ("numpy", "dtype")])
PAYLOAD_KEYS = ("iteration", "stage", "params", "opt_m", "opt_v", "opt_step",
                "num_active", "max_radii2d", "xyz_gradient_accum", "denom",
                "deformation_table", "deformation_accum", "aabb",
                "active_sh_degree")
BUFFER_KEYS = ("max_radii2d", "xyz_gradient_accum", "denom",
               "deformation_table", "deformation_accum")


class RefusedClass(pickle.UnpicklingError):
    """A JAX checkpoint names a class that is not a numpy array's."""


class _NumpyUnpickler(pickle.Unpickler):
    def __init__(self, f, path):
        super().__init__(f)
        self.path = path

    def find_class(self, module, name):
        if (module, name) not in ALLOWED:
            raise RefusedClass(
                f"{self.path}: refused {module}.{name}: a JAX checkpoint "
                f"holds numpy arrays, dtypes and scalars only")
        return super().find_class(module, name)


def checkpoint_format(path: str) -> str:
    """"torch" for the port's own file (a zip, as torch.save writes it),
    "jax" for a pickle (the JAX package's layout); raises for the JAX
    package's orbax directory and for anything else, naming the path."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, the JAX package's orbax checkpoint: the "
            f"port reads no orbax. Have the JAX package write its pickle "
            f"checkpoint (chkpnt_<stage>_<iteration>.pth) with "
            f"runtime.orbax_ckpt off")
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head[:1] == b"\x80":
        return "jax"
    raise ValueError(f"{path} is neither a torch.save file nor a pickle of "
                     f"the JAX package's checkpoint (it starts {head!r})")


def read_jax_payload(path: str) -> dict:
    """The checkpoint's dict of numpy arrays, unpickled under ALLOWED."""
    try:
        with open(path, "rb") as f:
            payload = _NumpyUnpickler(f, path).load()
    except RefusedClass:
        raise
    except Exception as e:       # truncated or corrupt: named, never skipped
        raise ValueError(f"{path}: not a readable JAX checkpoint "
                         f"({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: holds a {type(payload).__name__}, not "
                         f"the JAX package's checkpoint dict")
    missing = [k for k in PAYLOAD_KEYS if k not in payload]
    if missing:
        raise ValueError(f"{path}: no {missing[0]!r} in the checkpoint")
    return payload


def _leaves(tree, prefix="") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a pytree of nested dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _check_leaves(payload: dict, dcfg: DeformConfig, path: str) -> None:
    """Every leaf of params, opt_m and opt_v is a float32 array, the three
    trees agree leaf for leaf, the Gaussian leaves share one capacity with
    the buffers, and the deform subtree maps onto DeformNetwork(dcfg) with
    every leaf of the shape it expects and none left over."""
    params = payload["params"]
    if not isinstance(params, dict) or set(params) != {*GAUSSIAN_KEYS,
                                                       "deform"}:
        got = sorted(params) if isinstance(params, dict) else type(params)
        raise ValueError(f"{path}: params holds {got}, not the Gaussian "
                         f"leaves {list(GAUSSIAN_KEYS)} and 'deform'")
    want = dict(_leaves(params))
    for tree in ("params", "opt_m", "opt_v"):
        got = dict(_leaves(payload[tree]))
        if set(got) != set(want):
            diff = sorted(set(got) ^ set(want))
            raise ValueError(f"{path}: {tree} and params differ at "
                             f"{diff[0]}")
        for leaf, a in got.items():
            if not (isinstance(a, np.ndarray) and a.dtype == np.float32
                    and a.shape == want[leaf].shape):
                raise ValueError(
                    f"{path}: {tree}{leaf} is "
                    f"{getattr(a, 'dtype', type(a).__name__)} "
                    f"{getattr(a, 'shape', '')}, not float32 "
                    f"{want[leaf].shape}")
    cap = params["xyz"].shape[0]
    for k in (*GAUSSIAN_KEYS, *BUFFER_KEYS):
        a = params[k] if k in GAUSSIAN_KEYS else payload[k]
        if not isinstance(a, np.ndarray) or a.shape[:1] != (cap,):
            raise ValueError(f"{path}: {k} has {getattr(a, 'shape', a)!r}, "
                             f"not {cap} rows as xyz")
    if not 0 <= int(payload["num_active"]) <= cap:
        raise ValueError(f"{path}: num_active {payload['num_active']} "
                         f"outside 0..{cap}")
    try:
        sd = params_from_jax(params["deform"], dcfg)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{path}: params['deform'] lacks {e} that the "
                         f"DeformConfig needs") from e
    expect: Dict[str, tuple] = {k: tuple(v.shape) for k, v in
                                DeformNetwork(dcfg).state_dict().items()}
    for k, shape in expect.items():
        got = tuple(sd[k].shape) if k in sd else None
        if got != shape:
            raise ValueError(f"{path}: deform leaf {k} has shape {got}; the "
                             f"DeformConfig gives {shape}")
    n = sum(1 for _ in _leaves(params["deform"]))
    if n != len(expect):
        raise ValueError(f"{path}: params['deform'] holds {n} leaves; the "
                         f"DeformConfig maps {len(expect)} (a head or grid "
                         f"it does not build?)")


def _check_config(payload: dict, dcfg: DeformConfig, path: str) -> None:
    """The payload against the config the caller trains with, as `dcfg`
    carries it (DeformConfig.from_config): `aabb` float32 [2, 3];
    0 <= active_sh_degree <= max_sh_degree; f_rest of (max_sh_degree + 1)^2
    - 1 coefficients of 3 colours; language_feature as wide as the saved
    stage's language width, lang_dim, or centers_num * lang_dim on
    fine-lang-discrete. Nothing is coerced."""
    aabb = payload["aabb"]
    if not (isinstance(aabb, np.ndarray) and aabb.dtype == np.float32
            and aabb.shape == (2, 3)):
        raise ValueError(
            f"{path}: aabb is {getattr(aabb, 'dtype', type(aabb).__name__)} "
            f"{getattr(aabb, 'shape', '')}, not float32 (2, 3)")
    sh = dcfg.max_sh_degree
    active = payload["active_sh_degree"]
    if not (np.ndim(active) == 0 and np.issubdtype(np.asarray(active).dtype,
                                                   np.integer)
            and 0 <= int(active) <= sh):
        raise ValueError(f"{path}: active_sh_degree {active!r} is not an "
                         f"integer in 0..{sh}, the config's sh_degree")
    params = payload["params"]
    coeffs = (sh + 1) ** 2 - 1
    f_rest = params["f_rest"].shape[1:]
    if f_rest != (coeffs, 3):
        raise ValueError(f"{path}: f_rest holds {f_rest} per Gaussian; "
                         f"sh_degree {sh} gives ({coeffs}, 3)")
    stage = payload["stage"]
    width = dcfg.lang_dim * (dcfg.centers_num
                             if stage == "fine-lang-discrete" else 1)
    lang = params["language_feature"].shape[1:]
    if lang != (width,):
        raise ValueError(
            f"{path}: language_feature holds {lang} per Gaussian; stage "
            f"{stage!r} at lang_dim {dcfg.lang_dim}"
            + (f" x centers_num {dcfg.centers_num}"
               if stage == "fine-lang-discrete" else "")
            + f" gives ({width},)")


def load_jax_checkpoint(path: str, dcfg: DeformConfig, device=None):
    """The JAX package's `save_checkpoint` file -> (TrainState on `device`,
    the payload). The pickle holds no DeformConfig: `dcfg` comes from the
    config the caller trains with, and every deform leaf, `aabb`,
    `active_sh_degree` and the widths of f_rest and language_feature are
    checked against it. The Adam moments and step, `num_active`, the
    densification buffers, `aabb` and `active_sh_degree` are restored as
    saved. Raises, naming the file, on a class other than numpy's, a
    truncated file, or a leaf that does not fit. `device=None` is the
    current CUDA device (an error where there is none)."""
    payload = read_jax_payload(path)
    _check_leaves(payload, dcfg, path)
    _check_config(payload, dcfg, path)
    jstate = SimpleNamespace(
        params=payload["params"],
        opt=SimpleNamespace(m=payload["opt_m"], v=payload["opt_v"],
                            step=int(payload["opt_step"])),
        num_active=int(payload["num_active"]), aabb=payload["aabb"],
        active_sh_degree=int(payload["active_sh_degree"]),
        **{k: payload[k] for k in BUFFER_KEYS})
    return train_state_from_jax(jstate, dcfg, device=device), payload
