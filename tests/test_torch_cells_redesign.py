"""The logic that the Hopper design of the cell and tile-list compositors
adds, through its plain PyTorch twins in langsplat4d_torch/ops/composite.py
(the CUDA kernels run only on the card; tests/test_torch_cuda_kernel.py
holds them to the plain versions there).

(a) With hard cutoffs the tile-list kernel drops a row of a tile's list
    where the tile test (`quadrant_covered` of the shared forward walk, with
    the 16x16 tile as the rect) finds that no pixel of the tile can blend
    it. `tile_cover_plain` is that test: it must never drop a (row, tile)
    with a pixel that the blend's own rule would blend, here on cell rows
    (every (tile, candidate) pair whose rect covers the tile, adversarial
    ones included), and both culled schemes must give the plain output
    exactly, with the same live pairs: the lists'
    (`composite_tiles_plain(cull=True)`), and the cells'
    (`composite_cells_plain(cull=True)`), whose pairs the cell kernel's
    bound charges.
(b) The cell kernel decodes a rect corner v = x + 256 y without fmod or
    division; `rect_decode_plain` is that decode and must equal the fmod
    decode for every packed value.
"""
import pytest
import torch

from chip_smoke import (case_counts, make_cells, synthetic_lists)
from langsplat4d_torch.ops import composite as C

CELLS, CELL = (3, 2), 4
CASES = [("synthetic", 0), ("synthetic", 1), ("adversarial", 0),
         ("adversarial", 1), ("adversarial", 2)]


def cells_of(kind, seed, pw=16):
    return make_cells(kind, pw, torch.Generator().manual_seed(seed), CELLS,
                      CELL)


def covered_pairs(rows, starts):
    """Every (tile, candidate) pair whose rect covers the tile -> (rows
    [P, PW], tile x [P], tile y [P])."""
    out, txs, tys = [], [], []
    lt = torch.arange(CELL * CELL)
    for ci in range(starts.numel() - 1):
        cand = rows[int(starts[ci]):int(starts[ci + 1])]
        tx = (ci % CELLS[0]) * CELL + lt % CELL
        ty = (ci // CELLS[0]) * CELL + lt // CELL
        min_x, min_y = C.rect_decode_plain(cand[:, 6])
        max_x, max_y = C.rect_decode_plain(cand[:, 7])
        cov = ((min_x <= tx[:, None]) & (tx[:, None] < max_x)
               & (min_y <= ty[:, None]) & (ty[:, None] < max_y))
        t_idx, r_idx = cov.nonzero(as_tuple=True)
        out.append(cand[r_idx])
        txs.append(tx[t_idx])
        tys.append(ty[t_idx])
    return torch.cat(out), torch.cat(txs), torch.cat(tys)


@pytest.mark.parametrize("kind,seed", CASES,
                         ids=[f"{k}-{s}" for k, s in CASES])
def test_tile_test_drops_only_rows_no_pixel_blends(kind, seed):
    rows, starts = cells_of(kind, seed)
    r, tx, ty = covered_pairs(rows, starts)
    keep = C.tile_cover_plain(r, (tx * 16).float(), (ty * 16).float())
    assert keep.shape == (r.shape[0],) and keep.dtype == torch.bool
    # every pair against the 256 pixels of its tile, by the blend's rule
    _, _, skip = C._TileGrid(tx, ty, 16).alpha(r, hard_cutoffs=True)
    blends = ~skip.all(dim=1)
    assert blends.any()
    assert not (blends & ~keep).any()
    # the test is worth its cost: most of what no pixel blends goes
    assert int((~keep).sum()) >= 0.75 * int((~blends).sum())


def test_tile_test_keeps_what_it_cannot_judge():
    # an indefinite conic, a NaN, an opacity above 1: all kept, however far
    # from the tile; the padded slots' sentinel ln_op and a far splat go
    rows = torch.zeros((5, 16))
    rows[:, 0:2] = 100.0
    rows[:, 2:5] = torch.tensor([1.0, 0.0, 1.0])
    rows[:, 5] = -1.0
    rows[0, 2:5] = torch.tensor([1.0, 2.0, 1.0])
    rows[1, 2] = float("nan")
    rows[2, 5] = 1e4
    rows[3, 5] = -1e30
    keep = C.tile_cover_plain(rows, torch.zeros(5), torch.zeros(5))
    assert keep.tolist() == [True, True, True, False, False]
    assert C.tile_cover_plain(rows, torch.zeros(5), torch.zeros(5),
                              hard_cutoffs=False).all()


@pytest.mark.parametrize("hard", [True, False], ids=["hard1", "hard0"])
@pytest.mark.parametrize("kind,seed,pw", [("synthetic", 1, 24),
                                          ("adversarial", 0, 16),
                                          ("adversarial", 1, 32)],
                         ids=["synthetic-1", "adversarial-0",
                              "adversarial-1"])
def test_culled_cells_composite_to_the_plain_image(kind, seed, pw, hard):
    rows, starts = cells_of(kind, seed, pw)
    bg = torch.tensor([0.2, 0.5, 0.8])
    kw = dict(cells_x=CELLS[0], cell=CELL, hard_cutoffs=hard)
    whole, culled = {}, {}
    want = C.composite_cells_plain(rows, starts, bg, stats=whole, **kw)
    got = C.composite_cells_plain(rows, starts, bg, cull=True, stats=culled,
                                  **kw)
    assert torch.equal(got, want)
    assert float(want[:, :, pw - 8].max()) > 0.5        # something is drawn
    assert culled["live_pair_pixels"] == whole["live_pair_pixels"]
    assert culled["rect_tests"] == whole["rect_tests"] == (
        rows.shape[0] * CELL * CELL)
    assert culled["covered_rows"] == whole["covered_rows"] == (
        whole["kept_rows"])
    if hard:
        # nothing is dropped without hard cutoffs; with them the rows that
        # no pixel blends go, and their evaluations with them
        assert culled["kept_rows"] < 0.8 * culled["covered_rows"]
        assert culled["pair_pixels"] < whole["pair_pixels"]
    else:
        assert culled == whole


@pytest.mark.parametrize("hard", [True, False], ids=["hard1", "hard0"])
@pytest.mark.parametrize("seed", [0, 1])
def test_culled_tile_lists_composite_to_the_plain_output(seed, hard):
    g = torch.Generator().manual_seed(seed)
    tx, ty, k_cap = 6, 4, 96
    rows, counts = synthetic_lists(tx, ty, k_cap,
                                   case_counts(tx * ty, k_cap, g), g)
    bg = torch.tensor([0.2, 0.5, 0.8])
    kw = dict(tiles_x=tx, hard_cutoffs=hard)
    whole, culled = {}, {}
    want = C.composite_tiles_plain(rows, counts, bg, stats=whole, **kw)
    got = C.composite_tiles_plain(rows, counts, bg, cull=True, stats=culled,
                                  **kw)
    assert torch.equal(got, want)
    assert culled["live_pair_pixels"] == whole["live_pair_pixels"]
    assert whole["kept_rows"] == int(torch.clamp(counts, max=k_cap).sum())
    if hard:
        assert culled["kept_rows"] < whole["kept_rows"]
        assert culled["pair_pixels"] < whole["pair_pixels"]
    else:
        assert culled == whole


def test_rect_decode_is_exact_for_every_packed_corner():
    x = torch.arange(256).repeat(256).float()
    y = torch.arange(256).repeat_interleave(256).float()
    v = x + 256.0 * y
    got_x, got_y = C.rect_decode_plain(v)
    fmod_x = torch.fmod(v, 256.0)
    assert torch.equal(got_x, fmod_x) and torch.equal(got_y,
                                                      (v - fmod_x) / 256.0)
    assert torch.equal(got_x, x) and torch.equal(got_y, y)
