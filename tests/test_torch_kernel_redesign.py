"""The two pieces of logic that the Hopper designs of the stream compositor
and of the backward walk add, through their plain PyTorch twins in
langsplat4d_torch/ops/composite.py (the CUDA kernels run only on the card;
tests/test_torch_cuda_kernel.py holds them to the plain versions there).

(a) The stream kernel composites a 32-px tile as four 16x16 quadrants, and
    with hard cutoffs a quadrant only stages the rows that
    `quadrant_covered` keeps for it. `quadrant_cover_plain` is that test:
    it must never drop a (row, quadrant) with a pixel that
    `composite_stream_plain` would blend, and compositing every quadrant
    from its kept rows (`composite_stream_quadrants_plain`) must give
    `composite_stream_plain`'s image exactly: same rows in the same order
    with the same arithmetic, the dropped ones contributing exactly zero.
(b) The backward kernels reduce the 6 + C sums of a Gaussian across a warp
    with one transposed exchange; `warp_transpose_sum_plain` is its lane
    schedule: lane v must end with the sum of term v over all 32 lanes,
    each term counted once (exact on integers).
"""
import pytest
import torch

from chip_smoke import adversarial_stream, case_segments, synthetic_stream
from langsplat4d_torch.ops import composite as C

TILES = (4, 3)          # 32-px tiles
IMAGE = (72, 110)       # both edges cut through a quadrant


def make_stream(kind, seed, pw=16):
    g = torch.Generator().manual_seed(seed)
    tx, ty = TILES
    if kind == "adversarial":
        return adversarial_stream(tx, ty, 120, g, pw=pw)
    seg = case_segments(tx * ty, g)
    seg[1], seg[tx * ty - 2] = 400, 260
    return synthetic_stream(tx, ty, 32, seg, g, pw=pw)


def tile_of_rows(starts):
    seg = (starts[1:] - starts[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(seg.numel()), seg)
    return tile % TILES[0], tile // TILES[0]


STREAMS = [("segments", 0), ("segments", 1), ("adversarial", 0),
           ("adversarial", 1), ("adversarial", 2)]


@pytest.mark.parametrize("kind,seed", STREAMS,
                         ids=[f"{k}-{s}" for k, s in STREAMS])
def test_quadrant_test_drops_only_rows_no_pixel_blends(kind, seed):
    rows, starts = make_stream(kind, seed)
    tx, ty = tile_of_rows(starts)
    keep = C.quadrant_cover_plain(rows, (tx * 32).float(), (ty * 32).float(),
                                  hard_cutoffs=True)
    assert keep.shape == (rows.shape[0], 4) and keep.dtype == torch.bool
    dropped = 0
    for q in range(4):
        # every row against the 256 pixels of quadrant q of its own tile,
        # by the blend's own rule
        grid = C._TileGrid(tx, ty, 32, side=16, x0=16 * (q % 2),
                           y0=16 * (q // 2))
        _, _, skip = grid.alpha(rows, hard_cutoffs=True)
        blends = ~skip.all(dim=1)
        assert not (blends & ~keep[:, q]).any()
        dropped += int((~keep[:, q]).sum())
        # the test is worth its cost: most of what no pixel blends goes
        assert int((~keep[:, q]).sum()) >= 0.9 * int((~blends).sum())
    assert dropped > rows.shape[0]      # more than a quadrant a row


def test_quadrant_test_keeps_everything_without_hard_cutoffs():
    rows, starts = make_stream("adversarial", 0)
    tx, ty = tile_of_rows(starts)
    keep = C.quadrant_cover_plain(rows, (tx * 32).float(), (ty * 32).float(),
                                  hard_cutoffs=False)
    assert keep.all()


def test_quadrant_test_keeps_what_it_cannot_judge():
    # an indefinite conic, a NaN, an opacity above 1: all kept; the padded
    # slots' sentinel ln_op is dropped
    rows = torch.zeros((4, 16))
    rows[:, 0:2] = 100.0                 # far from the tile at the origin
    rows[:, 2:5] = torch.tensor([1.0, 0.0, 1.0])
    rows[:, 5] = -1.0
    rows[0, 2:5] = torch.tensor([1.0, 2.0, 1.0])
    rows[1, 2] = float("nan")
    rows[2, 5] = 1e4
    rows[3, 5] = -1e30
    keep = C.quadrant_cover_plain(rows, torch.zeros(4), torch.zeros(4))
    assert keep[:3].all() and not keep[3].any()


@pytest.mark.parametrize("hard", [True, False], ids=["hard1", "hard0"])
@pytest.mark.parametrize("kind,seed", STREAMS[1:4],
                         ids=[f"{k}-{s}" for k, s in STREAMS[1:4]])
def test_quadrants_composite_to_the_plain_image(kind, seed, hard):
    rows, starts = make_stream(kind, seed, pw=24 if seed == 1 else 16)
    bg = torch.tensor([0.2, 0.5, 0.8])
    kw = dict(tiles_x=TILES[0], tiles_y=TILES[1], tile_size=32,
              height=IMAGE[0], width=IMAGE[1], hard_cutoffs=hard)
    whole, parts = {}, {}
    want = C.composite_stream_plain(rows, starts, bg, stats=whole, **kw)
    got = C.composite_stream_quadrants_plain(rows, starts, bg, stats=parts,
                                             **kw)
    assert torch.equal(got, want)
    assert float(want[-1].max()) > 0.5                  # something is drawn
    # the same pairs are blended; with hard cutoffs far fewer are evaluated
    assert parts["live_pair_pixels"] == whole["live_pair_pixels"]
    assert parts["quadrant_tests"] == 4 * rows.shape[0]
    if hard:
        assert parts["pair_pixels"] < 0.6 * whole["pair_pixels"]
        assert parts["staged_rows"] < 0.6 * parts["quadrant_tests"]
    else:
        assert parts["staged_rows"] == parts["quadrant_tests"]


def test_quadrants_are_those_of_32_px_tiles():
    rows, starts = make_stream("segments", 0)
    with pytest.raises(ValueError, match="tile size"):
        C.composite_stream_quadrants_plain(
            rows, starts, torch.zeros(3), tiles_x=8, tiles_y=6, tile_size=16,
            height=72, width=110)


@pytest.mark.parametrize("v", [14, 22, 30])
def test_warp_transpose_sum_counts_every_term_once(v):
    g = torch.Generator().manual_seed(v)
    values = torch.randint(-1000, 1000, (32, v), generator=g).double()
    out = C.warp_transpose_sum_plain(values)
    assert out.shape == (32,)
    assert torch.equal(out[:v], values.sum(0))
    # one term alone lands on its own lane and nowhere among the first v
    for lane, term in ((0, 0), (17, v - 1), (31, 6)):
        one = torch.zeros((32, v), dtype=torch.float64)
        one[lane, term] = 1.0
        want = torch.zeros(v, dtype=torch.float64)
        want[term] = 1.0
        assert torch.equal(C.warp_transpose_sum_plain(one)[:v], want)


def test_warp_transpose_sum_in_float32_is_a_fixed_order():
    g = torch.Generator().manual_seed(0)
    values = torch.randn((32, 14), generator=g)
    out = C.warp_transpose_sum_plain(values)
    assert torch.equal(out, C.warp_transpose_sum_plain(values.clone()))
    torch.testing.assert_close(out[:14], values.double().sum(0).float(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="values"):
        C.warp_transpose_sum_plain(torch.zeros((16, 14)))


@pytest.mark.parametrize("name,source", [
    ("QUAD", "composite_common.cuh"),
    ("COVER_MARGIN_ABS", "composite_common.cuh"),
    ("COVER_MARGIN_REL", "composite_common.cuh"),
    ("LN_ALPHA_MIN", "composite_common.cuh"),
    ("ALPHA_MIN", "composite_common.cuh"),
    ("T_EPS", "composite_common.cuh"),
    ("MAX_ALPHA", "composite_common.cuh"),
])
def test_plain_twins_use_the_sources_constants(name, source):
    # the twins restate constants of the CUDA sources; nothing else holds
    # the two equal
    import re
    text = (C.CSRC / source).read_text()
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", text)
    assert m, f"{name} not found in {source}"
    value = eval(m.group(1).replace("f", ""))    # 1e-2f, 1.0f / 255.0f
    assert float(value) == pytest.approx(float(getattr(C, name)), rel=1e-7)
