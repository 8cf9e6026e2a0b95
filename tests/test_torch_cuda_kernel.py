"""The CUDA stream compositor against its plain PyTorch version, on the card
(chip_smoke.py phase 2 at pytest scale). Skips where there is no CUDA
device; run on the GPU with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernel.py` (the suite's conftest imports jax, which
the GPU machine lacks). Bound 3e-5, the repo's kernel bound."""
import pytest
import torch

from chip_smoke import compare_case, kernel_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", kernel_cases(),
                         ids=lambda c: f"ts{c[0]}-hard{int(c[1])}-pw{c[4]}")
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
