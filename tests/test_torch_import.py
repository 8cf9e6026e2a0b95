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
    "langsplat4d_torch.config",
    "langsplat4d_torch.core.device",
    "langsplat4d_torch.core.plyio",
    "langsplat4d_torch.core.transforms",
    "langsplat4d_torch.core.sh",
    "langsplat4d_torch.core.state",
    "langsplat4d_torch.data.cameras",
    "langsplat4d_torch.data.png",
    "langsplat4d_torch.data.jpeg",
    "langsplat4d_torch.data.resample",
    "langsplat4d_torch.data.codec",
    "langsplat4d_torch.data.colmap",
    "langsplat4d_torch.data.panoptic",
    "langsplat4d_torch.data.readers",
    "langsplat4d_torch.data.scene",
    "langsplat4d_torch.data.prefetch",
    "langsplat4d_torch.data.gt_cache",
    "langsplat4d_torch.ops.knn",
    "langsplat4d_torch.ops.point_utils",
    "langsplat4d_torch.ops.grid_sample",
    "langsplat4d_torch.ops.composite",
    "langsplat4d_torch.ops.kmeans",
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
    "langsplat4d_torch.utils.telemetry",
    "langsplat4d_torch.utils.timer",
    "langsplat4d_torch.utils.logging",
    "langsplat4d_torch.utils.profiling",
    "langsplat4d_torch.utils.network_gui",
    "langsplat4d_torch.utils.scene_vis",
    "langsplat4d_torch.train.losses",
    "langsplat4d_torch.train.optim",
    "langsplat4d_torch.train.trainstate",
    "langsplat4d_torch.train.step",
    "langsplat4d_torch.train.densify",
    "langsplat4d_torch.train.loop",
    "langsplat4d_torch.train.__main__",
    "langsplat4d_torch.render.__main__",
    "langsplat4d_torch.ae",
    "langsplat4d_torch.ae.model",
    "langsplat4d_torch.ae.data",
    "langsplat4d_torch.ae.train",
    "langsplat4d_torch.ae.test",
    "langsplat4d_torch.eval",
    "langsplat4d_torch.eval.relevancy",
    "langsplat4d_torch.eval.colormaps",
    "langsplat4d_torch.eval.evaluate",
    "langsplat4d_torch.eval.__main__",
    "langsplat4d_torch.preprocess",
    "langsplat4d_torch.preprocess.preprocess_neu3d",
    "langsplat4d_torch.preprocess.mask_nms",
    "langsplat4d_torch.preprocess.clip_features",
    "langsplat4d_torch.preprocess.image_prompt",
    "langsplat4d_torch.preprocess.video_captions",
    "langsplat4d_torch.preprocess.video_features",
)
# libraries a GPU host may lack: the port imports none of them
HOST_LACKS = ("cv2", "PIL", "matplotlib", "sklearn")
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


def test_port_imports_no_cv2_pil_matplotlib_or_sklearn():
    """In a clean interpreter whose import system refuses jax, flax, the
    JAX package, cv2, PIL, matplotlib and sklearn: every module of the port
    imports, the AE and the eval CLI among them (the two plot helpers import
    matplotlib only when called), and `load_image` decodes a PNG and a JPEG
    and resizes them through the port's codec."""
    refused = ("jax", "jaxlib", "flax", "langsplat4d") + HOST_LACKS
    code = textwrap.dedent(f"""
        import sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {refused!r}:
                    raise ImportError("refused: " + name)

        sys.meta_path.insert(0, Refuse())
    """) + "".join(f"import {m}\n" for m in SLICE) + textwrap.dedent(f"""
        import os, tempfile
        import numpy as np
        from langsplat4d_torch.data.jpeg import jpeg_bytes
        from langsplat4d_torch.data.png import png_bytes
        from langsplat4d_torch.data.readers import load_image
        img = (np.arange(12 * 10 * 3) % 251).astype(np.uint8).reshape(
            12, 10, 3)
        d = tempfile.mkdtemp()
        for name, data in (("a.png", png_bytes(img, 4)),
                           ("a.jpg", jpeg_bytes(img, 95))):
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
            out = load_image(os.path.join(d, name), resize=(5, 6),
                             filt="lanczos")
            assert out.shape == (3, 6, 5) and out.dtype == np.float32
        bad = sorted(m for m in sys.modules if m.split(".")[0] in {refused!r})
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
    if entry == "create_from_pcd":
        return state.create_from_pcd(z((5, 3)), z((5, 3)))
    if entry == "mean_knn_dist2":
        from langsplat4d_torch.ops.knn import mean_knn_dist2
        return mean_knn_dist2(z((5, 3)))
    if entry == "training":
        from langsplat4d_torch.config import Config
        from langsplat4d_torch.train.loop import training
        return training(Config())
    if entry == "load_checkpoint":
        from langsplat4d_torch.train.loop import load_checkpoint
        return load_checkpoint(str(tmp_path / "none.pth"))
    if entry == "ae_load_ckpt":
        from langsplat4d_torch.ae.model import load_ckpt
        return load_ckpt(os.path.join(REPO, "tests", "fixtures",
                                      "golden_quality", "ae_best_ckpt.pth"),
                         [8, 3], [8, 16])
    if entry == "ae_from_numpy":
        return interop.ae_from_numpy({})
    if entry == "ae_train":
        from langsplat4d_torch.ae.train import main
        return main(["--dataset_path", str(tmp_path), "--model_name", "m"])
    if entry == "ae_test":
        from langsplat4d_torch.ae.test import main
        return main(["--dataset_path", str(tmp_path), "--model_name", "m"])
    if entry == "train_cli":
        from langsplat4d_torch.train.__main__ import main
        return main(["--source_path", str(tmp_path), "--model_path",
                     str(tmp_path / "m"), "--port", "-1"])
    if entry == "render_cli":
        from langsplat4d_torch.render.__main__ import main
        return main(["--source_path", str(tmp_path), "--model_path",
                     str(tmp_path / "m")])
    if entry == "eval":
        from langsplat4d_torch.eval.__main__ import main
        return main(["--exp_name", "e", "--iterations", "1",
                     "--annotation_folder", str(tmp_path),
                     "--ae_ckpt_path", str(tmp_path / "none.pth"),
                     "--output_path", str(tmp_path / "out")])
    if entry == "mask_nms":
        from langsplat4d_torch.preprocess.mask_nms import mask_nms
        return mask_nms(z((2, 4, 4), bool), z(2))
    if entry == "masks_from_stack":
        from langsplat4d_torch.preprocess.clip_features import (
            masks_from_stack)
        return masks_from_stack(z((4, 4, 4), np.int32))
    if entry == "highlight_object":
        from langsplat4d_torch.preprocess.image_prompt import (
            highlight_object)
        return highlight_object(z((4, 4, 3), np.uint8), z((4, 4), bool))
    if entry == "encode_feature":
        from langsplat4d_torch.preprocess.video_features import (
            encode_feature)
        return encode_feature(str(tmp_path), "f", str(tmp_path), None)
    return synth.realistic_gaussians(10)


@pytest.mark.parametrize("entry", [
    "load_trained_model", "gaussians_from_numpy", "load_deformation",
    "from_arrays", "realistic_gaussians", "create_from_pcd",
    "mean_knn_dist2", "training", "load_checkpoint", "ae_load_ckpt",
    "ae_from_numpy", "ae_train", "ae_test", "eval", "train_cli",
    "render_cli", "mask_nms", "masks_from_stack", "highlight_object",
    "encode_feature"])
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
    assert tuple(composite.ENTRY_POINTS)[:len(WRAPPERS)] == WRAPPERS
    for name in WRAPPERS:
        assert list(composite.ENTRY_POINTS[name]) == [name]
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
