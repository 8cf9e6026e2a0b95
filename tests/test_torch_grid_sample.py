"""The port's grid_sample_2d: F.grid_sample's forward, bit for bit, and a
backward of its own that sums the plane gradient per cell in a fixed order
(no float atomics on the card). Gradients against `jax.grad` through the JAX
package's corner-gather form, and against aten's autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from langsplat4d.ops.grid_sample import grid_sample_2d as j_grid_sample
from langsplat4d_torch.ops.grid_sample import grid_sample_2d
from langsplat4d_torch.train import loop

TOL = 1e-5


def assert_coords_close(got, want):
    """The coordinates' gradient within TOL of the largest entry: it is the
    plane's slope times (W - 1) / 2 summed over channels, tens here, where
    one float32 rounding is already about 4e-6; the plane gradient is held
    at TOL absolute."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _case(kind, seed=0, C=4, H=9, W=13, n=400):
    rng = np.random.default_rng(seed)
    plane = rng.normal(size=(C, H, W)).astype(np.float32)
    if kind == "inside":
        co = rng.uniform(-0.999, 0.999, size=(n, 2))
    elif kind == "beyond":          # outside [-1, 1]: the border clamp
        co = rng.uniform(-1.5, 1.5, size=(n, 2))
        co[: n // 2] = np.sign(co[: n // 2]) * rng.uniform(
            1.001, 2.0, size=(n // 2, 2))
    else:                           # many points in one cell
        co = rng.uniform(0.10, 0.11, size=(n, 2))
    gout = rng.normal(size=(len(co), C)).astype(np.float32)
    return plane, co.astype(np.float32), gout


def _port(plane, co, gout):
    p = torch.tensor(plane, requires_grad=True)
    c = torch.tensor(co, requires_grad=True)
    out = grid_sample_2d(p, c)
    (out * torch.from_numpy(gout)).sum().backward()
    return out.detach().numpy(), p.grad.numpy(), c.grad.numpy()


def _aten(plane, co, gout):
    p = torch.tensor(plane, requires_grad=True)
    c = torch.tensor(co, requires_grad=True)
    out = F.grid_sample(p[None], c[None, :, None, :], mode="bilinear",
                        padding_mode="border", align_corners=True)
    out = out[0, :, :, 0].T
    (out * torch.from_numpy(gout)).sum().backward()
    return out.detach().numpy(), p.grad.numpy(), c.grad.numpy()


def _jax(plane, co, gout):
    def f(pl, cc):
        return jnp.sum(j_grid_sample(pl, cc) * gout)
    gp, gc = jax.grad(f, (0, 1))(jnp.asarray(plane), jnp.asarray(co))
    return np.asarray(gp), np.asarray(gc)


@pytest.mark.parametrize("kind", ["inside", "beyond", "one_cell"])
def test_forward_is_aten_and_gradients_match_jax(kind):
    plane, co, gout = _case(kind)
    out, gp, gc = _port(plane, co, gout)
    a_out, a_gp, a_gc = _aten(plane, co, gout)
    np.testing.assert_array_equal(out, a_out)         # bit for bit
    j_gp, j_gc = _jax(plane, co, gout)
    np.testing.assert_allclose(gp, j_gp, rtol=0, atol=TOL)
    assert_coords_close(gc, j_gc)
    np.testing.assert_allclose(gp, a_gp, rtol=0, atol=TOL)
    assert_coords_close(gc, a_gc)
    if kind == "beyond":            # the clamp's derivative is 0 there
        out_x = np.abs(co[:, 0]) > 1
        assert np.all(gc[out_x, 0] == 0)


def test_coordinates_exactly_on_the_border():
    """Points on the corners and edges of [-1, 1]^2. The plane gradient
    matches the JAX package. The coordinates' gradient is aten's: the clip
    counts the border as out of bounds and gives 0 there. `jnp.clip` gives
    half the slope on its bounds, so the JAX package differs from aten at
    -1, where the slope into the plane is not 0 (ROADMAP queue 3); at +1 the
    far corner is the border cell itself and both give 0."""
    plane, _, _ = _case("inside")
    rng = np.random.default_rng(3)
    co = np.array([[1, 1], [-1, -1], [1, -1], [-1, 1], [-1, 0.3],
                   [0.4, -1], [1, 0.2], [0.7, 1]], np.float32)
    gout = rng.normal(size=(len(co), plane.shape[0])).astype(np.float32)
    out, gp, gc = _port(plane, co, gout)
    a_out, a_gp, a_gc = _aten(plane, co, gout)
    np.testing.assert_array_equal(out, a_out)
    assert_coords_close(gc, a_gc)
    j_gp, j_gc = _jax(plane, co, gout)
    np.testing.assert_allclose(gp, j_gp, rtol=0, atol=TOL)
    assert np.all(gc[np.abs(co) == 1] == 0)
    low = co == -1
    assert np.abs(j_gc[low]).min() > 0.1          # JAX: half the slope
    np.testing.assert_array_equal(j_gc[co == 1], 0.0)


def test_backward_is_bit_reproducible():
    """Two backward calls on the same inputs give the same bits. On the CPU
    this shows the code path; chip_smoke.py phase 21 shows it on the card,
    where aten's backward adds with atomics."""
    plane, co, gout = _case("one_cell", seed=5, n=4000)
    _, gp1, gc1 = _port(plane, co, gout)
    _, gp2, gc2 = _port(plane, co, gout)
    np.testing.assert_array_equal(gp1, gp2)
    np.testing.assert_array_equal(gc1, gc2)


def test_one_input_without_gradient():
    plane, co, gout = _case("inside", seed=2)
    p = torch.tensor(plane, requires_grad=True)
    (grid_sample_2d(p, torch.from_numpy(co)) * torch.from_numpy(gout)
     ).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), _jax(plane, co, gout)[0],
                               rtol=0, atol=TOL)
    c = torch.tensor(co, requires_grad=True)
    (grid_sample_2d(torch.from_numpy(plane), c) * torch.from_numpy(gout)
     ).sum().backward()
    assert_coords_close(c.grad.numpy(), _jax(plane, co, gout)[1])


def test_every_stage_runs_deterministic():
    """The loop turns PyTorch's deterministic algorithms on for a GPU in
    every stage (no stage argument), restores the setting after, and
    leaves the CPU alone."""
    import inspect
    assert list(inspect.signature(loop.deterministic_on).parameters) == [
        "device"]
    before = torch.are_deterministic_algorithms_enabled()
    with loop.deterministic_on(torch.device("cuda")):
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == before
    with loop.deterministic_on(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled() == before


@pytest.mark.parametrize("chunk", [4, 8, 256])
@pytest.mark.parametrize("layout", ["spread", "row", "cell"])
def test_kernel_scheme_sums_as_the_plain_version(layout, chunk):
    """The CUDA kernel's scheme (csrc/plane_grad.cu), step by step on the
    CPU: keys past the plane for points without a gradient, one stable
    sort, a segmented scan per chunk of sorted entries, runs that cross
    chunks merged in order. Against plane_grad_plain, with runs longer
    than many chunks (`row`: a time plane at one time; `cell`: every point
    in one cell) and a third of the points padding (one position, a zero
    gradient)."""
    from langsplat4d_torch.ops.grid_sample import (plane_grad_plain,
                                                   plane_grad_scheme_plain)
    rng = np.random.default_rng(6)
    C, H, W, n = 4, 9, 13, 700
    plane = torch.tensor(rng.normal(size=(C, H, W)), dtype=torch.float32)
    co = rng.uniform(-1.2, 1.2, size=(n, 2))
    if layout == "row":
        co[:, 1] = -0.4
    elif layout == "cell":
        co[:] = rng.uniform(0.10, 0.11, size=(n, 2))
    g = torch.tensor(rng.normal(size=(n, C)), dtype=torch.float32)
    co[::3] = 0.0
    g[::3] = 0.0
    co = torch.tensor(co, dtype=torch.float32)
    want = plane_grad_plain(plane, co, g)[0]
    got = plane_grad_scheme_plain(plane, co, g, chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL * max(1.0, float(want.abs().max())))


def test_plane_grad_wrapper_has_no_fallback():
    """The plain version only for CPU tensors; other devices raise."""
    import ast
    import inspect
    import textwrap
    from langsplat4d_torch.ops import grid_sample as G
    tree = ast.parse(textwrap.dedent(inspect.getsource(G.plane_grad)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    m = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        G.plane_grad(torch.zeros((2, 3, 4), **m), torch.zeros((5, 2), **m),
                     torch.zeros((5, 2), **m))
    bumps = [ast.unparse(n) for n in ast.walk(tree)
             if isinstance(n, ast.AugAssign)]
    assert bumps == ["plane_grad.launches += 1"]


def test_plane_grad_source_is_plain_cuda():
    import re
    from langsplat4d_torch.ops import composite
    src = composite.kernel_source("plane_grad").read_text()
    assert re.findall(r"#include\s+(\S+)", src) == ["<cuda_runtime.h>",
                                                     "<stdint.h>"]
    assert not re.search(r"\batomic\w*\s*\(", src)       # no atomics
    assert not re.search(r"cublas|cudnn|cutlass|torch/", src, re.I)
    for entry in ("ls4d_plane_grad_corners", "ls4d_dense_grid_corners",
                  "ls4d_plane_grad_sums", "ls4d_cuda_error_string"):
        assert f'extern "C"' in src and f" {entry}(" in src
    assert "plane_grad" not in composite.KERNELS
    assert sorted(composite.ENTRY_POINTS["plane_grad"]) == [
        "dense_grid_corners", "plane_grad_corners", "plane_grad_sums"]


def _dense_case(kind, seed=0, C=2, world=(6, 5, 7), n=400):
    """A DenseGrid [1, C, *world], its AABB, points and an output gradient:
    `inside` the AABB; `beyond` it (corners off the grid read 0); `padded`,
    a third of the points at one position with a zero gradient, as a
    GaussianState's padding."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(C, *world)).astype(np.float32)
    aabb = np.asarray([[1.5] * 3, [-1.5] * 3], np.float32)
    lim = 1.49 if kind == "inside" else 1.9
    pts = rng.uniform(-lim, lim, size=(n, 3)).astype(np.float32)
    gout = rng.normal(size=(n, C)).astype(np.float32)
    if kind == "padded":
        pts[::3] = 0.37
        gout[::3] = 0.0
    return grid, aabb, pts, gout


@pytest.mark.parametrize("kind", ["inside", "beyond", "padded"])
def test_dense_grid_query_backward_is_the_ports(kind):
    """field/hexplane.dense_grid_query: the forward bit-equal to
    F.grid_sample in 3-D (align_corners, zeros outside); the backward is
    the port's own (`ops/grid_sample.dense_grid_grad`, no float atomics on
    the card), within 1e-5 of jax.grad through the JAX package's corner
    gathers (langsplat4d/field/hexplane.py:72-106) for the grid, and
    within 1e-5 of the largest entry for the points (`assert_coords_close`:
    the grid's slope times (N - 1) / 2, around 10 here)."""
    from langsplat4d.field import hexplane as JH
    from langsplat4d_torch.field import hexplane as TH
    grid, aabb, pts, gout = _dense_case(kind)

    def jf(grid, pts):
        return (JH.dense_grid_query(grid, jnp.asarray(aabb), pts)
                * gout).sum()
    jg, jp = jax.grad(jf, (0, 1))(jnp.asarray(grid), jnp.asarray(pts))
    dense = TH.DenseGrid(grid.shape[0], grid.shape[1:])
    with torch.no_grad():
        dense.grid.copy_(torch.from_numpy(grid)[None])
    p = torch.tensor(pts, requires_grad=True)
    box = torch.from_numpy(aabb)
    out = TH.dense_grid_query(dense, box, p)
    ind = ((p - box[1]) / (box[0] - box[1])).flip(-1) * 2 - 1
    ref = F.grid_sample(dense.grid, ind.reshape(1, 1, 1, -1, 3),
                        mode="bilinear", align_corners=True)
    assert torch.equal(out, ref.reshape(grid.shape[0], -1).T)
    assert type(out.grad_fn).__name__ == "_DenseGridSampleBackward"
    (out * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(dense.grid.grad[0].numpy(), np.asarray(jg),
                               rtol=0, atol=TOL)
    assert_coords_close(p.grad.numpy(), np.asarray(jp))


@pytest.mark.parametrize("chunk", [8, 256])
def test_dense_grid_scheme_sums_as_the_plain_version(chunk):
    """The card's sum of the grid gradient, step by step on the CPU: the
    eight corner keys (off the grid and zero-gradient points keyed past
    it, so the padding makes no run), then the segmented sums of
    csrc/plane_grad.cu (`segment_sums_scheme_plain`), against
    dense_grid_grad_plain's index_add_; points crowded into a few cells
    make runs across many chunks."""
    from langsplat4d_torch.ops import grid_sample as G
    grid, aabb, pts, gout = _dense_case("padded", seed=4, n=600)
    pts[1::3] = np.random.default_rng(4).uniform(0.1, 0.12, (200, 3))
    box = torch.from_numpy(aabb)
    ind = ((torch.from_numpy(pts) - box[1]) / (box[0] - box[1])).flip(-1) \
        * 2 - 1
    g = torch.from_numpy(gout)
    keys, wts = G.dense_grid_keys(grid.shape, ind, g)
    C, D, H, W = grid.shape
    assert keys.dtype == torch.int32 and keys.numel() == 8 * len(pts)
    assert int((keys.reshape(8, -1)[:, ::3] >= D * H * W).sum()) == 8 * 200
    got = G.segment_sums_scheme_plain(keys.long(), wts, g, D * H * W, chunk)
    want = G.dense_grid_grad_plain(torch.from_numpy(grid), ind, g)[0]
    np.testing.assert_allclose(got.T.reshape(C, D, H, W).numpy(),
                               want.numpy(), rtol=0, atol=TOL)


def test_dense_grid_grad_wrapper_has_no_fallback():
    """The plain version only for CPU tensors; other devices raise; the
    launch counter goes up where the kernel launches and nowhere else."""
    import ast
    import inspect
    import textwrap
    from langsplat4d_torch.ops import grid_sample as G
    tree = ast.parse(textwrap.dedent(inspect.getsource(G.dense_grid_grad)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    m = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        G.dense_grid_grad(torch.zeros((1, 2, 3, 4), **m),
                          torch.zeros((5, 3), **m), torch.zeros((5, 1), **m))
    bumps = [ast.unparse(n) for n in ast.walk(tree)
             if isinstance(n, ast.AugAssign)]
    assert bumps == ["dense_grid_grad.launches += 1"]
