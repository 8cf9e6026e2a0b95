"""The CUDA compositors against their plain PyTorch versions, on the card
(chip_smoke.py phases 2, 7, 12 and 17 at pytest scale). Skips where there is
no CUDA device; run on the GPU with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernel.py` (the suite's conftest imports jax, which
the GPU machine lacks). Forward bound 3e-5, the repo's kernel bound; the
backward kernels are held to the repo's gradient bound, rtol 2e-3 / atol
2e-4 (their block reductions sum in another order than the plain
versions); on the long synthetic segments that bound is taken relative to
each column's largest entry, for the reason `compare_segment_case` gives."""
import pytest
import torch

from chip_smoke import (cell_cases, compare_case, compare_cell_case,
                        compare_list_case, compare_segment_case,
                        kernel_cases, list_cases, segment_cases)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", kernel_cases(),
                         ids=lambda c: f"ts{c[0]}-hard{int(c[1])}-pw{c[4]}-{c[5]}")
def test_kernel_matches_plain(cuda_device, case):
    assert compare_case(*case, device=cuda_device, seed=1) <= 3e-5


def test_kernel_launch_is_counted_and_checked(cuda_device):
    from langsplat4d_torch.ops.composite import composite_stream
    rows = torch.zeros((0, 16), device=cuda_device)
    starts = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    before = composite_stream.launches
    out = composite_stream(rows, starts, bg, tiles_x=2, tiles_y=2,
                           tile_size=16, height=20, width=30)
    assert composite_stream.launches == before + 1
    torch.cuda.synchronize()
    want = torch.zeros((9, 20, 30), device=cuda_device)
    want[:3] = bg[:, None, None]          # empty segments: bg, no alpha
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="row width"):
        composite_stream(torch.zeros((1, 12), device=cuda_device), starts,
                         bg, tiles_x=2, tiles_y=2, tile_size=16, height=20,
                         width=30)


@pytest.mark.parametrize("case", list_cases(),
                         ids=lambda c: f"hard{int(c[0])}-pw{c[1]}")
def test_list_kernels_match_plain(cuda_device, case):
    fwd_err, _, bwd_excess = compare_list_case(*case, device=cuda_device,
                                               seed=1)
    assert fwd_err <= 3e-5
    assert bwd_excess <= 0.0


def test_list_kernel_launches_are_counted_and_checked(cuda_device):
    from langsplat4d_torch.ops.composite import (composite_tiles,
                                                 composite_tiles_backward)
    rows = torch.randn((3, 8, 16), device=cuda_device)
    counts = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    before = composite_tiles.launches, composite_tiles_backward.launches
    out = composite_tiles(rows, counts, bg, tiles_x=3)
    g_out = torch.ones_like(out)
    d_rows = composite_tiles_backward(rows, counts, g_out, (out * g_out).sum(1),
                                      tiles_x=3)
    torch.cuda.synchronize()
    assert (composite_tiles.launches,
            composite_tiles_backward.launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = torch.zeros((3, 9, 256), device=cuda_device)
    want[:, :3] = bg[None, :, None]       # empty lists: bg, no alpha
    assert torch.equal(out, want)
    assert torch.equal(d_rows, torch.zeros_like(rows))
    with pytest.raises(ValueError, match="tile size"):
        composite_tiles(rows, counts, bg, tiles_x=3, tile_size=32)
    with pytest.raises(ValueError, match="counts"):
        composite_tiles(rows, counts.long(), bg, tiles_x=3)


@pytest.mark.parametrize("case", segment_cases(),
                         ids=lambda c: f"hard{int(c[0])}-pw{c[1]}")
def test_stream_train_kernels_match_plain(cuda_device, case):
    fwd_err, _, bwd_excess = compare_segment_case(*case, device=cuda_device,
                                                  seed=1)
    assert fwd_err <= 3e-5
    assert bwd_excess <= 0.0


def test_stream_train_kernel_launches_are_counted_and_checked(cuda_device):
    from langsplat4d_torch.ops.composite import (
        composite_stream_chunks, composite_stream_chunks_backward)
    rows = torch.zeros((0, 16), device=cuda_device)
    starts = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    before = (composite_stream_chunks.launches,
              composite_stream_chunks_backward.launches)
    out = composite_stream_chunks(rows, starts, bg, tiles_x=3)
    g_out = torch.ones_like(out)
    d_rows = composite_stream_chunks_backward(
        rows, starts, g_out, (out * g_out).sum(1), tiles_x=3)
    torch.cuda.synchronize()
    assert (composite_stream_chunks.launches,
            composite_stream_chunks_backward.launches) == (before[0] + 1,
                                                           before[1] + 1)
    want = torch.zeros((3, 9, 256), device=cuda_device)
    want[:, :3] = bg[None, :, None]       # empty segments: bg, no alpha
    assert torch.equal(out, want)
    assert d_rows.shape == (0, 16)
    with pytest.raises(ValueError, match="tile size"):
        composite_stream_chunks(rows, starts, bg, tiles_x=3, tile_size=32)
    with pytest.raises(ValueError, match="starts"):
        composite_stream_chunks(rows, starts.long(), bg, tiles_x=3)
    with pytest.raises(ValueError, match="g_out"):
        composite_stream_chunks_backward(rows, starts, g_out[:, :8],
                                         (out * g_out).sum(1), tiles_x=3)


@pytest.mark.parametrize("case", cell_cases(),
                         ids=lambda c: f"hard{int(c[0])}-pw{c[1]}-{c[2]}")
def test_cell_kernel_matches_plain(cuda_device, case):
    assert compare_cell_case(*case, device=cuda_device, seed=1) <= 3e-5


def test_cell_kernel_launch_is_counted_and_checked(cuda_device):
    from langsplat4d_torch.ops.composite import composite_cells
    rows = torch.zeros((0, 16), device=cuda_device)
    starts = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    before = composite_cells.launches
    out = composite_cells(rows, starts, bg, cells_x=2, cell=2)
    torch.cuda.synchronize()
    assert composite_cells.launches == before + 1
    want = torch.zeros((2, 4, 9, 256), device=cuda_device)
    want[:, :, :3] = bg[None, None, :, None]   # no candidates: bg, no alpha
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="row width"):
        composite_cells(torch.zeros((1, 12), device=cuda_device), starts, bg,
                        cells_x=2, cell=2)
    with pytest.raises(ValueError, match="cell_starts"):
        composite_cells(rows, starts.long(), bg, cells_x=2, cell=2)
