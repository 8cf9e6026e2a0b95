"""The port imports torch and never jax, and its CUDA wrapper has no
fallback to the plain version."""
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
    "langsplat4d_torch.render.stream",
    "langsplat4d_torch.render.pipeline",
    "langsplat4d_torch.render.driver",
    "langsplat4d_torch.utils.synth",
)


def test_port_never_imports_jax():
    """In a clean interpreter (this process has jax loaded by conftest):
    import the package and every slice module, and load the golden
    checkpoint, then check that no jax or flax module was imported."""
    code = "".join(f"import {m}\n" for m in SLICE) + textwrap.dedent("""
        import sys
        import langsplat4d_torch
        from langsplat4d_torch.checkpoint import load_trained_model
        from langsplat4d_torch.field.deformation import DeformConfig
        load_trained_model(
            "tests/fixtures/golden_quality", "fine-lang", -1,
            DeformConfig(kplanes_resolution=(64, 64, 64, 25),
                         multires=(1, 2), no_do=False))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_cuda_wrapper_has_no_fallback():
    """The plain version is reached only under `rows.device.type == "cpu"`,
    and nothing in the wrapper catches an exception."""
    from langsplat4d_torch.ops import composite
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(composite.composite_stream)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    plain_calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "composite_stream_plain"]
    assert len(plain_calls) == 1
    guards = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and any(c is plain_calls[0] for b in n.body
                      for c in ast.walk(b))]
    assert len(guards) == 1
    assert ast.unparse(guards[0].test) == "rows.device.type == 'cpu'"


def test_wrapper_refuses_devices_without_a_kernel():
    from langsplat4d_torch.ops.composite import composite_stream
    rows = torch.zeros((4, 16), device="meta")
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        composite_stream(rows, starts, torch.zeros(3, device="meta"),
                         tiles_x=1, tiles_y=1, tile_size=16, height=16,
                         width=16)
