"""The stream-layout training composite, JAX vs the port, on the same numpy
scenes (64 px, as tests/test_stream_train.py).

- `build_stream_train`: the port's dense segments equal the valid slots of
  the JAX package's chunk-aligned build, tile by tile, with the ellipse cull
  on and off and with Gaussians of equal depth.
- The plain forward and backward (what the CUDA kernels are held to on the
  card) against the TPU kernels in interpret mode. The TPU kernels resume a
  stopped pixel at the next chunk; the port keeps the CUDA reference's stop
  for good. So with hard cutoffs JAX gets one chunk per tile (g spans the
  longest segment), where the two rules coincide; with the cutoffs off it
  gets several chunks per tile, which holds the T and the prefix that its
  kernels carry from chunk to chunk.
- `StreamCV` gradients against `jax.vjp` of `composite_stream_train`.
- Inside the port: the stream-train image and gradients equal the tile-list
  path's where no list truncates and stay right where the lists truncate;
  `include_feature=False`; `maybe_stream_switch`.

Bounds: forward 3e-5 (the repo's kernel bound,
tests/test_pallas_composite.py:58), but 3e-4 in the depth channel, whose
values are ~5 so that 3e-5 is a few ulp (the repo's own depth bound,
tests/test_pallas_composite.py:85-86; the TPU kernels form T as a product
per chunk, the port one Gaussian at a time); gradients rtol 2e-3 / atol 2e-4
(the repo's gradient bound, :172-175), for the rasterizer's inputs relative
to each input's largest gradient entry as tests/test_torch_step.py does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.core import state as jstatelib
from langsplat4d.field.deformation import init_deform_params
from langsplat4d.ops import tile_composite as JTC
from langsplat4d.render import pipeline as JP
from langsplat4d.render import raster as JR
from langsplat4d.render import stream as JS
from langsplat4d.render import stream_vjp as JSV
from langsplat4d.train.trainstate import make_train_state as j_make_state
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import train_state_from_jax
from langsplat4d_torch.ops import composite as TC
from langsplat4d_torch.render import pipeline as TP
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.render import stream as TS
from langsplat4d_torch.render import stream_vjp as TSV
from langsplat4d_torch.train.loop import maybe_stream_switch
from tests.test_raster import make_camera, random_scene
from tests.test_train import tiny_dcfg

H = W = 64
TIERS = ((3, 256), (6, 256), (16, 256))
BUDGET = 8192
FWD_TOL = 3e-5
DEPTH_TOL = 3e-4
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
BG = np.asarray([0.2, 0.1, 0.3], np.float32)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _assert_forward_close(got, want):
    """accum [T, 8, px] = [rgb, lang, depth, alpha] at the bounds above."""
    rest = [0, 1, 2, 3, 4, 5, 7]
    np.testing.assert_allclose(got[:, rest], want[:, rest], atol=FWD_TOL)
    np.testing.assert_allclose(got[:, 6], want[:, 6], atol=DEPTH_TOL)


def _scene(rng, n=96, cluster=1.0, big=6):
    means, scales, quats, opac, colors, lang = random_scene(rng, n=n)
    means = (means * cluster).astype(np.float32)
    scales[:big] *= 6.0                 # splats spanning several tiles
    return means, scales, quats, opac, colors, lang


def _prep(arrs, hard_cutoffs=True, tie_depths=False):
    """The JAX preprocess of a scene -> (prep as numpy, packed [N, 13])."""
    means, scales, quats, opac, colors, lang = arrs
    n = means.shape[0]
    js = JR.RasterSettings(H, W, sh_degree=0, lang_dim=3,
                           hard_cutoffs=hard_cutoffs)
    prep = JR.preprocess(js, make_camera(H, W), jnp.asarray(means),
                         jnp.zeros((n, 2)), jnp.asarray(opac),
                         jnp.asarray(scales), jnp.asarray(quats), None,
                         jnp.asarray(colors))
    prep = {k: np.array(v) for k, v in prep.items()}
    if tie_depths:
        prep["depth"] = np.round(prep["depth"] * 2.0) / 2.0
    packed = np.concatenate(
        [prep["point_image"], prep["conic"], prep["opacity"][:, None],
         prep["colors"], lang, prep["depth"][:, None]], axis=1)
    return prep, packed


def _jax_build(prep, g, hard_cutoffs=True, cull=True):
    js = JR.RasterSettings(H, W, sh_degree=0, lang_dim=3,
                           hard_cutoffs=hard_cutoffs, stream_train=True,
                           stream_tiers=TIERS, stream_budget=BUDGET,
                           stream_train_chunk=g)
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    ov = JS.stream_overflow(js, jprep, tiers=TIERS)
    assert int(ov["span_exceeded"]) == 0           # the tiers clip nothing
    info = JS.build_stream_train(js, jprep, tiers=TIERS, budget=BUDGET,
                                 chunk=g, ellipse_cull=cull)
    assert int(info["n_valid"]) <= BUDGET
    return js, {k: np.asarray(v) for k, v in info.items()}


def _torch_build(prep, hard_cutoffs=True, cull=True):
    ts = TR.RasterSettings(H, W, hard_cutoffs=hard_cutoffs, stream_train=True,
                           stream_ellipse_cull=cull)
    src, starts = TS.build_stream_train(
        ts, {k: torch.from_numpy(v) for k, v in prep.items()}, cull)
    return ts, src, starts


def _slot_map(info, starts):
    """For every slot of the port's dense stream, its slot in the JAX
    package's aligned stream: segment by segment, the valid slots in
    order."""
    jstarts, valid = info["starts"], info["valid"]
    out = []
    for t in range(len(starts) - 1):
        n_t = int(starts[t + 1] - starts[t])
        seg = np.arange(jstarts[t], jstarts[t + 1])
        assert valid[seg].sum() == n_t and valid[seg[:n_t]].all()
        out.append(seg[:n_t])
    return np.concatenate(out)


@pytest.mark.parametrize("cull,tie_depths",
                         [(True, False), (False, False), (True, True)])
def test_build_matches_jax_valid_slots(rng, cull, tie_depths):
    prep, _ = _prep(_scene(rng), tie_depths=tie_depths)
    _, info = _jax_build(prep, 32, cull=cull)
    ts, src, starts = _torch_build(prep, cull=cull)
    starts, src = starts.numpy(), src.numpy()
    assert starts.dtype == np.int32 and starts.shape == (ts.num_tiles + 1,)
    assert starts[0] == 0 and starts[-1] == len(src) == info["n_valid"] > 0
    seg_len = np.diff(starts)
    assert seg_len.min() == 0 and seg_len.max() > 32   # empty and long tiles
    jsrc = info["src"][_slot_map(info, starts)]
    depth = prep["depth"]
    if not tie_depths:
        np.testing.assert_array_equal(src, jsrc)
        return
    # Equal depths: the JAX build ranks depth with an unstable argsort, so
    # within a run of equal depths its order is arbitrary. Every segment
    # holds the same Gaussians at the same depths slot by slot, and the
    # port orders a run by index, as its tile lists do.
    assert len(np.unique(depth[prep["visible"]])) < 12
    np.testing.assert_array_equal(depth[src], depth[jsrc])
    ties = 0
    for t in range(ts.num_tiles):
        a = src[starts[t]:starts[t + 1]]
        assert sorted(a) == sorted(jsrc[starts[t]:starts[t + 1]])
        tie = depth[a[1:]] == depth[a[:-1]]
        ties += tie.sum()
        assert (a[1:][tie] > a[:-1][tie]).all()
    assert ties > 20


def _both_rows(rng, hard_cutoffs, several_chunks):
    """A scene's stream in both layouts: (jax settings, info, jax rows
    [15, B_al], port settings, port rows [B, 16], starts, slot map)."""
    prep, packed = _prep(_scene(rng), hard_cutoffs)
    ts, src, starts = _torch_build(prep, hard_cutoffs)
    longest = int(np.diff(starts.numpy()).max())
    g = 16 if several_chunks else -(-longest // 32) * 32
    assert (longest > 2 * g) if several_chunks else (longest <= g)
    js, info = _jax_build(prep, g, hard_cutoffs)
    jrows = JSV._stream_rows(jnp.asarray(packed), jnp.asarray(info["src"]),
                             jnp.asarray(info["valid"]))
    rows = TSV.stream_rows(torch.from_numpy(packed), src)
    assert rows.shape == (len(src), 16)              # 15 columns padded
    return js, info, jrows, ts, rows, starts, _slot_map(info, starts.numpy())


CASES = [(True, False), (False, True), (False, False)]
CASE_IDS = ["hard-1chunk", "soft-chunks", "soft-1chunk"]


@pytest.mark.parametrize("hard_cutoffs,several_chunks", CASES, ids=CASE_IDS)
def test_plain_forward_matches_pallas(rng, hard_cutoffs, several_chunks):
    js, info, jrows, ts, rows, starts, _ = _both_rows(rng, hard_cutoffs,
                                                     several_chunks)
    got = TC.composite_stream_chunks(
        rows, starts, torch.from_numpy(BG), tiles_x=ts.tiles_x,
        hard_cutoffs=hard_cutoffs).numpy()
    want = np.asarray(JTC.composite_stream_chunks_pallas(
        jrows, jnp.asarray(info["chunk_tile"]), jnp.asarray(BG),
        tiles_x=js.tiles_x, num_tiles=js.num_tiles,
        g=js.stream_train_chunk, hard_cutoffs=hard_cutoffs))
    assert got.shape == (ts.num_tiles, 9, 256)
    assert want[:, 7].max() > 0.5                    # real coverage
    _assert_forward_close(got[:, [0, 1, 2, 3, 4, 5, 6, 8]], want)
    assert np.abs(got[:, 7]).max() == 0.0            # the padded channel
    empty = np.diff(starts.numpy()) == 0
    assert empty.any()
    np.testing.assert_array_equal(
        got[empty][:, :3], np.broadcast_to(BG[None, :, None],
                                           (empty.sum(), 3, 256)))


@pytest.mark.parametrize("hard_cutoffs,several_chunks", CASES, ids=CASE_IDS)
def test_plain_backward_matches_pallas_rows(rng, hard_cutoffs,
                                            several_chunks):
    js, info, jrows, ts, rows, starts, slots = _both_rows(
        rng, hard_cutoffs, several_chunks)
    kw = dict(tiles_x=ts.tiles_x, hard_cutoffs=hard_cutoffs)
    accum = TC.composite_stream_chunks(rows, starts, torch.from_numpy(BG),
                                       **kw).numpy()
    g_out = rng.normal(size=accum.shape).astype(np.float32)
    g_out[:, 7] = 0.0                                # the padded channel
    total = (accum * g_out).sum(1)
    got = TC.composite_stream_chunks_backward(
        rows, starts, torch.from_numpy(g_out), torch.from_numpy(total),
        **kw).numpy()
    want = np.asarray(JTC.composite_stream_chunks_backward_pallas(
        jrows, jnp.asarray(info["chunk_tile"]),
        jnp.asarray(g_out[:, [0, 1, 2, 3, 4, 5, 6, 8]]), jnp.asarray(total),
        tiles_x=js.tiles_x, num_tiles=js.num_tiles,
        g=js.stream_train_chunk, hard_cutoffs=hard_cutoffs))   # [15, B_al]
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got[:, :15], want.T[slots], **GRAD_TOL)
    assert np.abs(got[:, 15]).max() == 0.0
    # the aligned stream's padding slots carry no gradient
    pad = np.ones(want.shape[1], bool)
    pad[slots] = False
    assert np.abs(want[:, pad]).max() == 0.0


@pytest.mark.parametrize("hard_cutoffs,several_chunks", CASES[:2],
                         ids=CASE_IDS[:2])
def test_stream_cv_grads_match_jax_vjp(rng, hard_cutoffs, several_chunks):
    prep, packed = _prep(_scene(rng), hard_cutoffs)
    ts, src, starts = _torch_build(prep, hard_cutoffs)
    longest = int(np.diff(starts.numpy()).max())
    g = 16 if several_chunks else -(-longest // 32) * 32
    js, info = _jax_build(prep, g, hard_cutoffs)
    tgt = rng.normal(size=(ts.num_tiles, 8, 256)).astype(np.float32)

    out, vjp = jax.vjp(
        lambda p, b: JSV.composite_stream_train(
            js, p, jnp.asarray(info["src"]), jnp.asarray(info["valid"]),
            jnp.asarray(info["chunk_tile"]), b),
        jnp.asarray(packed), jnp.asarray(BG))
    want_p, want_bg = (np.asarray(x) for x in vjp(jnp.asarray(tgt)))

    tp = torch.from_numpy(packed).requires_grad_(True)
    tbg = torch.from_numpy(BG.copy()).requires_grad_(True)
    accum = TSV.composite_stream_train(ts, tp, src, starts, tbg)
    _assert_forward_close(accum.detach().numpy(), np.asarray(out))
    accum.backward(torch.from_numpy(tgt))
    assert np.abs(want_p).max() > 1.0
    got_p = tp.grad.numpy()
    if hard_cutoffs:
        np.testing.assert_allclose(got_p, want_p, **GRAD_TOL)
    else:
        # With the cutoffs off the conic gradient is a difference of terms
        # 10^3 times the result in tiles far from a Gaussian's centre, and
        # the port sums over pixels in another order than the TPU kernel's
        # matrix products: the three conic columns get atol 1e-3 here, as
        # in tests/test_torch_composite_vjp.py; every other column keeps
        # the repo's bound.
        conic = [2, 3, 4]
        rest = [c for c in range(got_p.shape[1]) if c not in conic]
        np.testing.assert_allclose(got_p[:, rest], want_p[:, rest],
                                   **GRAD_TOL)
        np.testing.assert_allclose(got_p[:, conic], want_p[:, conic],
                                   rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(tbg.grad.numpy(), want_bg, **GRAD_TOL)


# ---- inside the port: the stream layout against the tile lists ----

def _torch_cam():
    cam = make_camera(H, W)
    return TR.CameraParams(*[torch.from_numpy(np.array(getattr(cam, f)))
                             for f in ("viewmatrix", "projmatrix", "campos",
                                       "tanfovx", "tanfovy")])


def _raster_loss_grads(settings, arrs, w_r, w_l):
    """rasterize under autograd -> (images, gradients of a fixed linear
    loss with respect to the six scene inputs)."""
    means, scales, quats, opac, colors, lang = (
        torch.from_numpy(a).requires_grad_(True) for a in arrs)
    feats = lang if settings.include_feature else lang[:, :0]
    rendered, lang_img, radii, depth = TR.rasterize(
        settings, _torch_cam(), means, opac, scales, quats, None, colors,
        feats, torch.from_numpy(BG))
    loss = (rendered * w_r).sum() + (lang_img * w_l[:lang_img.shape[0]]).sum()
    grads = torch.autograd.grad(
        loss, (means, scales, quats, opac, colors, lang), allow_unused=True)
    return ((rendered.detach(), lang_img.detach(), depth.detach(),
             radii.detach()),
            [None if g is None else g.numpy() for g in grads])


def _weights():
    r = np.random.default_rng(3)
    return (torch.from_numpy(r.normal(size=(3, H, W)).astype(np.float32)),
            torch.from_numpy(r.normal(size=(3, H, W)).astype(np.float32)))


NAMES = ("means", "scales", "quats", "opacity", "colors", "lang")


@pytest.mark.parametrize("include_feature", [True, False])
def test_stream_train_equals_lists_where_nothing_truncates(rng,
                                                           include_feature):
    arrs = _scene(rng)
    base = TR.RasterSettings(H, W, sh_degree=0,
                             include_feature=include_feature)
    lists = dataclasses.replace(base, analytic_vjp=True, tile_capacity=128)
    stream = dataclasses.replace(base, stream_train=True)
    w = _weights()
    img_l, g_l = _raster_loss_grads(lists, arrs, *w)
    img_s, g_s = _raster_loss_grads(stream, arrs, *w)
    full = TR.binning_saturation(lists, _torch_prep_of(arrs))
    assert float(full["tile_full_frac"]) == 0.0
    assert img_s[1].shape[0] == (3 if include_feature else 0)
    for a, b, what in zip(img_s, img_l, ("rgb", "lang", "depth", "radii")):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), err_msg=what,
            atol=DEPTH_TOL if what == "depth" else FWD_TOL)
    for a, b, what in zip(g_s, g_l, NAMES):
        if what == "lang" and not include_feature:
            assert a is None and b is None
            continue
        scale = np.abs(b).max()
        assert scale > 0, what
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=what)


def _torch_prep_of(arrs):
    means, scales, quats, opac, colors, _ = (torch.from_numpy(a)
                                             for a in arrs)
    return TR.preprocess(TR.RasterSettings(H, W, sh_degree=0), _torch_cam(),
                         means, opac, scales, quats, None, colors)


def _stressed_scene(rng, n=192):
    """One dense cluster (tests/test_stream_train.py:181-192): all Gaussians
    project into a few tiles, so lists of capacity 32 << n saturate."""
    means, scales, quats, opac, colors, lang = random_scene(rng, n=n)
    return ((means * 0.08).astype(np.float32), scales, quats, opac, colors,
            lang)


def test_stream_grads_right_where_lists_truncate(rng):
    arrs = _stressed_scene(rng)
    base = TR.RasterSettings(H, W, sh_degree=0)
    w = _weights()
    _, g_gold = _raster_loss_grads(dataclasses.replace(
        base, analytic_vjp=True, tile_capacity=192), arrs, *w)
    _, g_list = _raster_loss_grads(dataclasses.replace(
        base, analytic_vjp=True, tile_capacity=32), arrs, *w)
    _, g_stream = _raster_loss_grads(dataclasses.replace(
        base, stream_train=True), arrs, *w)

    def err(g):
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g, g_gold))
        den = sum(float((b ** 2).sum()) for b in g_gold) + 1e-30
        return (num / den) ** 0.5

    e_list, e_stream = err(g_list), err(g_stream)
    # the truncated lists must be measurably wrong here (else the scene lost
    # its point) and the stream right to rounding: the bounds of
    # tests/test_stream_train.py
    assert e_list > 1e-2, e_list
    assert e_stream < 1e-3, e_stream
    assert e_stream < e_list / 10


class _Cam:
    def camera_params(self, device):
        return TR.CameraParams(*[t.to(device) for t in _torch_cam()])


def _state_pair(means, colors, capacity):
    gs = jstatelib.create_from_pcd(np.asarray(means), np.asarray(colors),
                                   max_sh_degree=3, lang_dim=3,
                                   capacity=capacity)
    jd = tiny_dcfg(3)
    jstate = j_make_state(gs, init_deform_params(jax.random.PRNGKey(0), jd),
                          np.array([[1.6] * 3, [-1.6] * 3], np.float32))
    dcfg = DeformConfig(**{f.name: getattr(jd, f.name)
                           for f in dataclasses.fields(DeformConfig)})
    return jstate, train_state_from_jax(jstate, dcfg, device="cpu")


@pytest.mark.parametrize("stressed", [True, False])
def test_maybe_stream_switch(rng, stressed):
    if stressed:
        means, _, _, _, colors, _ = _stressed_scene(rng)
    else:
        means, _, _, _, colors, _ = random_scene(np.random.default_rng(5),
                                                 n=64)
    jstate, tstate = _state_pair(means, colors, 256)
    cap = 32 if stressed else 128     # as tests/test_stream_train.py
    settings = TR.RasterSettings(H, W, sh_degree=0, analytic_vjp=True,
                                 tile_capacity=cap)
    js = JR.RasterSettings(H, W, sh_degree=0, lang_dim=3, tile_capacity=cap,
                           composite_chunk=32, composite_tile_chunk=4)
    want = JP.binning_report(js, make_camera(H, W), jstate.gaussians())
    got = TP.binning_report(settings, _Cam().camera_params("cpu"),
                            tstate.gaussians())
    assert set(got) == {"tile_full_frac", "tile_max_count"}
    assert got["tile_full_frac"] == pytest.approx(want["tile_full_frac"],
                                                  abs=1e-6)
    switched = maybe_stream_switch(settings, tstate, [_Cam()], iteration=7)
    if stressed:
        assert got["tile_full_frac"] > 0.05 and got["tile_max_count"] > 32
        assert switched == dataclasses.replace(settings, stream_train=True)
    else:
        assert got["tile_full_frac"] <= 0.05
        assert switched is None


def test_settings_need_no_capacity_with_stream_train():
    s = TR.RasterSettings(H, W, stream_train=True, analytic_vjp=True)
    assert s.tile_capacity is None and s.stream_ellipse_cull
    with pytest.raises(ValueError, match="tile_capacity"):
        TR.RasterSettings(H, W, analytic_vjp=True)
    with pytest.raises(ValueError, match="tile_capacity"):
        TR.binning_saturation(s, {})
