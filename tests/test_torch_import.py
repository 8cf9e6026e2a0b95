"""The port imports torch and never jax, and its CUDA wrappers have no
fallback to their plain versions."""
import ast
import inspect
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = (
    "langsplat4d_torch.core.device",
    "langsplat4d_torch.core.plyio",
    "langsplat4d_torch.core.transforms",
    "langsplat4d_torch.core.sh",
    "langsplat4d_torch.core.state",
    "langsplat4d_torch.data.cameras",
    "langsplat4d_torch.ops.grid_sample",
    "langsplat4d_torch.ops.composite",
    "langsplat4d_torch.field.nets",
    "langsplat4d_torch.field.hexplane",
    "langsplat4d_torch.field.deformation",
    "langsplat4d_torch.interop",
    "langsplat4d_torch.checkpoint",
    "langsplat4d_torch.render.raster",
    "langsplat4d_torch.render.composite_vjp",
    "langsplat4d_torch.render.stream",
    "langsplat4d_torch.render.stream_vjp",
    "langsplat4d_torch.render.pipeline",
    "langsplat4d_torch.render.driver",
    "langsplat4d_torch.utils.synth",
    "langsplat4d_torch.train.losses",
    "langsplat4d_torch.train.optim",
    "langsplat4d_torch.train.trainstate",
    "langsplat4d_torch.train.step",
    "langsplat4d_torch.train.loop",
)
WRAPPERS = ("composite_stream", "composite_tiles", "composite_tiles_backward",
            "composite_stream_chunks", "composite_stream_chunks_backward",
            "composite_cells")


def test_port_never_imports_jax():
    """In a clean interpreter (this process has jax loaded by conftest) whose
    import system refuses jax, flax and the JAX package outright: import the
    port and every one of its modules, and load the golden checkpoint through the
    port's own PLY reader."""
    code = textwrap.dedent("""
        import sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "langsplat4d"):
                    raise ImportError("refused: " + name)

        sys.meta_path.insert(0, Refuse())
    """) + "".join(f"import {m}\n" for m in SLICE) + textwrap.dedent("""
        import langsplat4d_torch
        from langsplat4d_torch.checkpoint import load_trained_model
        from langsplat4d_torch.field.deformation import DeformConfig
        model, it = load_trained_model(
            "tests/fixtures/golden_quality", "fine-lang", -1,
            DeformConfig(kplanes_resolution=(64, 64, 64, 25),
                         multires=(1, 2), no_do=False), device="cpu")
        assert it == 1200 and model.gaussians.num_active > 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "langsplat4d"))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax_import():
    """No port source (the smoke script included) has an import statement of
    jax, flax or the JAX package."""
    import re
    pat = re.compile(r"^\s*(from|import) (jax|flax|langsplat4d)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "langsplat4d_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]    # build output
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def _call_without_device(entry, tmp_path):
    from langsplat4d_torch import checkpoint, interop
    from langsplat4d_torch.core import state
    from langsplat4d_torch.field.deformation import DeformConfig
    from langsplat4d_torch.utils import synth
    import numpy as np
    z = np.zeros
    if entry == "load_trained_model":
        return checkpoint.load_trained_model(
            os.path.join(REPO, "tests", "fixtures", "golden_quality"),
            "fine-lang", -1, DeformConfig())
    if entry == "gaussians_from_numpy":
        return interop.gaussians_from_numpy({})
    if entry == "load_deformation":
        return interop.load_deformation(str(tmp_path), DeformConfig())
    if entry == "from_arrays":
        return state.from_arrays(z((2, 3)), z((2, 1, 3)), z((2, 15, 3)),
                                 z((2, 3)), z((2, 4)), z((2, 1)))
    return synth.realistic_gaussians(10)


@pytest.mark.parametrize("entry", [
    "load_trained_model", "gaussians_from_numpy", "load_deformation",
    "from_arrays", "realistic_gaussians"])
def test_entry_points_default_to_cuda_and_raise_without_it(
        entry, tmp_path, monkeypatch):
    """Without a device argument the entry points go to the GPU; where there
    is none they raise, they do not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call_without_device(entry, tmp_path)


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrapper_has_no_fallback(name):
    """The plain version is reached only under `rows.device.type == "cpu"`,
    and nothing in the wrapper catches an exception."""
    from langsplat4d_torch.ops import composite
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(getattr(composite, name))))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    plain_calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == name + "_plain"]
    assert len(plain_calls) == 1
    guards = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and any(c is plain_calls[0] for b in n.body
                      for c in ast.walk(b))]
    assert len(guards) == 1
    assert ast.unparse(guards[0].test) == "rows.device.type == 'cpu'"
    # the launch count moves in the wrapper, once, after the launch
    bumps = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)]
    assert [ast.unparse(b) for b in bumps] == [f"{name}.launches += 1"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_devices_without_a_kernel(name):
    from langsplat4d_torch.ops import composite
    m = dict(device="meta")
    kw = dict(tiles_x=1, tile_size=16)
    with pytest.raises(ValueError, match="no kernel"):
        if name == "composite_stream":
            composite.composite_stream(
                torch.zeros((4, 16), **m),
                torch.zeros(2, dtype=torch.int32, **m), torch.zeros(3, **m),
                tiles_y=1, height=16, width=16, **kw)
        elif name == "composite_tiles":
            composite.composite_tiles(
                torch.zeros((1, 4, 16), **m),
                torch.zeros(1, dtype=torch.int32, **m), torch.zeros(3, **m),
                **kw)
        elif name == "composite_tiles_backward":
            composite.composite_tiles_backward(
                torch.zeros((1, 4, 16), **m),
                torch.zeros(1, dtype=torch.int32, **m),
                torch.zeros((1, 9, 256), **m), torch.zeros((1, 256), **m),
                **kw)
        elif name == "composite_stream_chunks":
            composite.composite_stream_chunks(
                torch.zeros((4, 16), **m),
                torch.zeros(2, dtype=torch.int32, **m), torch.zeros(3, **m),
                **kw)
        elif name == "composite_stream_chunks_backward":
            composite.composite_stream_chunks_backward(
                torch.zeros((4, 16), **m),
                torch.zeros(2, dtype=torch.int32, **m),
                torch.zeros((1, 9, 256), **m), torch.zeros((1, 256), **m),
                **kw)
        else:
            composite.composite_cells(
                torch.zeros((4, 16), **m),
                torch.zeros(2, dtype=torch.int32, **m), torch.zeros(3, **m),
                cells_x=1, cell=2)


def test_kernel_sources_are_plain_cuda():
    """Each kernel has its source under csrc/, built for sm_90a, including
    nothing but the CUDA runtime and the shared header; the header is part
    of every library's cache key."""
    from langsplat4d_torch.ops import composite
    import re
    assert "arch=compute_90a,code=sm_90a" in composite.NVCC_FLAGS
    assert "--fmad=false" in composite.NVCC_FLAGS
    assert composite.KERNELS == WRAPPERS
    assert set(composite._C_ARGS) == set(WRAPPERS)
    for name in composite.KERNELS:
        src = composite.kernel_source(name).read_text()
        assert re.findall(r"#include\s+(\S+)", src) == [
            '"composite_common.cuh"'], name
        assert f'extern "C" int ls4d_{name}(' in src
        assert not re.search(r"cublas|cudnn|cutlass|torch/", src, re.I)
    hdr = composite.COMMON_HEADER.read_text()
    assert re.findall(r"#include\s+(\S+)", hdr) == ["<cuda_runtime.h>"]
    with pytest.raises(ValueError, match="unknown kernel"):
        composite.kernel_source("composite_bands")
