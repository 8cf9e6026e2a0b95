"""The training step as a whole, JAX vs the port, from the same numpy state
and batch: the loss, the gradient of every leaf, the viewspace gradient,
visibility and radii, and the parameters after two `train_step`s, for
`coarse-base` and `fine-lang`, on the tile lists and on the stream layout
(`stream_train`); `train_step_packed` against `train_step`; and
`materialize_batch`; the plane regularizers and the SSIM term of the loss; the
state's helpers and `eval_step`.

The JAX side runs its analytic-VJP compositor (the jnp path the CPU uses)
with one chunk per list (composite_chunk = tile_capacity), where its stop
rule and the port's coincide, and exact top-k lists. In the stream-train
cases it runs its chunk-aligned stream build and the TPU kernel pair in
interpret mode, with tiers and a budget that clip nothing and one chunk per
tile (the chunk is as wide as the Gaussians' capacity, and a tile's segment
holds a Gaussian at most once), where again the stop rules coincide.

Bounds: loss 1e-5 relative. Gradients rtol 2e-3 with atol 2e-4 of the leaf's
largest entry (the repo's gradient bound, tests/test_pallas_composite.py,
taken relative to each leaf because the loss is a mean over pixels and the
raw gradients are ~1e-4, where an absolute 2e-4 would pass anything).
Parameters after two steps 5e-4 (the repo's cross-program bound,
tests/test_parallel.py:252).
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.config import OptimizationConfig
from langsplat4d.core import state as jstatelib
from langsplat4d.field.deformation import (DeformConfig as JDeformConfig,
                                           init_deform_params)
from langsplat4d.render import raster as JR
from langsplat4d.render import stream as JStream
from langsplat4d.train import optim as JO
from langsplat4d.train import step as JS
from langsplat4d.train.trainstate import make_train_state as j_make_state
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import params_from_jax, train_state_from_jax
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.train import optim as TO
from langsplat4d_torch.train import step as TS
from tests.test_raster import make_camera

H, W, K, N, CAP = 32, 48, 32, 50, 64
SMALL = dict(net_width=16, posebase_pe=2, kplanes_out_dim=4,
             kplanes_resolution=(8, 8, 8, 4), multires=(1,), lang_dim=3,
             no_do=False, no_dshs=False, no_ds=False, no_dlang=False)
GAUSS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
         "language_feature")
STAGES = {"coarse-base": dict(batch=1, no_dlang=True),
          "fine-lang": dict(batch=2, no_dlang=False)}


def _jax_state(rng):
    pts = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    cols = rng.uniform(size=(N, 3)).astype(np.float32)
    gs = jstatelib.create_from_pcd(pts, cols, max_sh_degree=3, lang_dim=3,
                                   capacity=CAP)
    lang = np.zeros((CAP, 3), np.float32)
    lang[:N] = rng.normal(size=(N, 3))
    f_rest = rng.normal(0, 0.05, size=(CAP, 15, 3)).astype(np.float32)
    opacity = np.array(gs.opacity)
    opacity[:N] = rng.normal(0.5, 1.0, size=(N, 1))
    scaling = np.array(gs.scaling)
    scaling[:N] = np.log(rng.uniform(0.03, 0.15, size=(N, 3)))
    gs = gs.replace(language_feature=jnp.asarray(lang),
                    features_rest=jnp.asarray(f_rest),
                    opacity=jnp.asarray(opacity),
                    scaling=jnp.asarray(scaling))
    jd = JDeformConfig(**SMALL)
    dparams = init_deform_params(jax.random.PRNGKey(0), jd)
    aabb = np.array([[1.6] * 3, [-1.6] * 3], np.float32)
    return j_make_state(gs, dparams, aabb, active_sh_degree=3), jd


def _batch(rng, b):
    cams = [make_camera(H, W, cam_z=-5.0 - 0.7 * i) for i in range(b)]
    cam = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    gt_lang = rng.normal(size=(b, 3, H, W)).astype(np.float32)
    mask = (rng.uniform(size=(b, 1, H, W)) > 0.2).astype(np.float32)
    return dict(cams=cam, times=np.linspace(0.3, 0.8, b).astype(np.float32),
                gt_images=rng.uniform(size=(b, 3, H, W)).astype(np.float32),
                gt_lang=gt_lang, lang_mask=mask)


#: the JAX stream build's static sizes: every tier takes all CAP Gaussians
#: and the budget every (Gaussian, tile) pair there can be, so nothing clips
STREAM = dict(stream_train=True, stream_train_chunk=CAP,
              stream_tiers=((3, CAP), (6, CAP), (16, CAP)),
              stream_budget=CAP * 8)


def _configs(stage, jd, stream=False, **extra):
    o = OptimizationConfig()
    js = JR.RasterSettings(H, W, sh_degree=3, lang_dim=3, tile_capacity=K,
                           composite_chunk=K, bin_tile_chunk=2,
                           two_level_binning=False,
                           **(STREAM if stream else {}))
    kw = dict(stage=stage, no_dlang=STAGES[stage]["no_dlang"], lam=0.2,
              **extra)
    jcfg = JS.StepConfig(settings=js, dcfg=jd,
                         lr_cfg=JO.LRConfig.from_optim(o, 1.0), **kw)
    ts = TR.RasterSettings(H, W, sh_degree=3, tile_capacity=K,
                           analytic_vjp=True, stream_train=stream)
    tcfg = TS.StepConfig(settings=ts, dcfg=DeformConfig(**SMALL),
                         lr_cfg=TO.LRConfig.from_optim(o, 1.0), **kw)
    return jcfg, tcfg


def _torch_batch(b):
    t = torch.from_numpy
    return TS.Batch(
        cams=TR.CameraParams(*[t(np.array(getattr(b["cams"], f))) for f in
                               ("viewmatrix", "projmatrix", "campos",
                                "tanfovx", "tanfovy")]),
        times=t(b["times"]), gt_images=t(b["gt_images"]),
        gt_lang=t(b["gt_lang"]), lang_mask=t(b["lang_mask"]))


def _jax_batch(b):
    return JS.Batch(cams=b["cams"], times=jnp.asarray(b["times"]),
                    gt_images=jnp.asarray(b["gt_images"]),
                    gt_lang=jnp.asarray(b["gt_lang"]),
                    lang_mask=jnp.asarray(b["lang_mask"]))


def _port_leaves(jparams, dcfg):
    """JAX params-shaped pytree -> {port leaf name: numpy array}."""
    out = {k: np.asarray(jparams[k]) for k in GAUSS}
    out.update({"deform." + k: v.numpy() for k, v in
                params_from_jax(jparams["deform"], dcfg).items()})
    return out


def _assert_grads_close(got, want, name):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * scale,
                               err_msg=name)


def _assert_stream_clips_nothing(js, jstate, cam):
    """`stream_overflow` on the undeformed Gaussians: no span beyond the
    tiers, no tier and no budget short of its demand."""
    gs = jstate.gaussians()
    prep = JR.preprocess(js, cam, gs.xyz, jnp.zeros((CAP, 2)),
                         jax.nn.sigmoid(gs.opacity), jnp.exp(gs.scaling),
                         gs.rotation, None, jnp.zeros((CAP, 3)),
                         active=gs.active_mask())
    ov = JStream.stream_overflow(js, prep, tiers=js.stream_tiers)
    assert int(ov["span_exceeded"]) == 0
    for i, (_, cap) in enumerate(js.stream_tiers):
        assert int(ov[f"tier{i + 2}_needed"]) <= cap
    assert js.num_tiles * CAP <= js.stream_budget
    assert js.stream_train_chunk >= CAP


@pytest.mark.parametrize("stage,stream", [
    pytest.param(st, flag, id=st + ("-stream" if flag else ""))
    for flag in (False, True) for st in STAGES])
def test_step_matches_jax(rng, stage, stream):
    with contextlib.ExitStack() as stack:
        if stream:      # the TPU kernel pair runs in interpret mode
            stack.enter_context(pltpu.force_tpu_interpret_mode())
        _check_step_matches_jax(rng, stage, stream)


def _check_step_matches_jax(rng, stage, stream):
    jstate, jd = _jax_state(rng)
    b = _batch(rng, STAGES[stage]["batch"])
    jcfg, tcfg = _configs(stage, jd, stream)
    if stream:
        assert tcfg.settings.stream_train and jcfg.settings.stream_train
        _assert_stream_clips_nothing(
            jcfg.settings, jstate, jax.tree.map(lambda x: x[0], b["cams"]))
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    tstate = train_state_from_jax(jstate, tcfg.dcfg, device="cpu")
    tbatch = _torch_batch(b)
    n_b = STAGES[stage]["batch"]

    # loss and the gradient of every leaf
    dummies = jnp.zeros((n_b, CAP, 2))
    (jg, jdummy), (jmetrics, jradii) = jax.jit(
        jax.grad(JS._loss_fn, argnums=(1, 6), has_aux=True),
        static_argnums=(0, 7))(
        jcfg, jstate.params, jstate.num_active, jstate.aabb, _jax_batch(b),
        jnp.asarray(bg), dummies, 3)
    names = list(tstate.leaves())
    metrics, grads, dummy_grads, radii = TS.loss_and_grads(
        tcfg, tstate, tbatch, torch.from_numpy(bg), 3, wrt=names)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    want = _port_leaves(jg, tcfg.dcfg)
    assert set(want) == set(names)
    reached = 0
    for name in names:
        if grads[name] is None:        # autograd: the loss does not reach it
            assert np.abs(want[name]).max() == 0.0, name
            continue
        if np.abs(want[name]).max() == 0.0:
            assert float(grads[name].abs().max()) == 0.0, name
            continue
        reached += 1
        _assert_grads_close(grads[name].numpy(), want[name], name)
    assert reached >= (6 if stage == "coarse-base" else 15)
    _assert_grads_close(dummy_grads.numpy(), np.asarray(jdummy), "dummies")
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jradii))

    # two steps
    jb, jbg = _jax_batch(b), jnp.asarray(bg)
    for it in (1, 2):
        jstate, jm, jvs, jvis, jrad = JS.train_step(
            jcfg, jstate, jb, jbg, jnp.asarray(it, jnp.int32), 3)
        tstate, tm, tvs, tvis, trad = TS.train_step(
            tcfg, tstate, tbatch, torch.from_numpy(bg), it, 3)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        _assert_grads_close(tvs.numpy(), np.asarray(jvs), "vs_grad")
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
        np.testing.assert_array_equal(trad.numpy(), np.asarray(jrad))
    assert tstate.opt.step == int(jstate.opt.step) == 2
    want = _port_leaves(jstate.params, tcfg.dcfg)
    start = _port_leaves(_jax_state(np.random.default_rng(0))[0].params,
                         tcfg.dcfg)
    moved = set()
    for name, p in tstate.leaves().items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=5e-4,
                                   rtol=0, err_msg=name)
        if not np.array_equal(p.detach().numpy(), start[name]):
            moved.add(name)
    if stage == "fine-lang":        # only these train; the rest is frozen
        assert moved == {"language_feature",
                         *[n for n in names if ".lang_deform." in n]}
    else:
        assert {"xyz", "f_dc", "f_rest", "opacity", "scaling",
                "rotation"} <= moved and "language_feature" not in moved


def test_regularized_loss_matches_jax(rng):
    """The optional terms of the loss: the HexPlane regularizers
    (`compute_regulation`, on when time_smoothness_weight != 0) and SSIM, in
    the loss and in the gradient of every HexPlane leaf. The time planes
    start at exactly 1, the kink of |1 - plane|: the port takes the JAX
    package's derivative there."""
    jstate, jd = _jax_state(rng)
    b = _batch(rng, 1)
    extra = dict(time_smoothness_weight=0.5, l1_time_planes=0.3,
                 plane_tv_weight=0.7, lambda_dssim=0.2)
    jcfg, tcfg = _configs("coarse-base", jd, **extra)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    tstate = train_state_from_jax(jstate, tcfg.dcfg, device="cpu")
    jg, (jmetrics, _) = jax.jit(
        jax.grad(JS._loss_fn, argnums=1, has_aux=True),
        static_argnums=(0, 7))(
        jcfg, jstate.params, jstate.num_active, jstate.aabb, _jax_batch(b),
        jnp.asarray(bg), jnp.zeros((1, CAP, 2)), 3)
    grid_names = [n for n in tstate.leaves() if ".grid.grids." in n]
    assert len(grid_names) == 6
    metrics, grads, _, _ = TS.loss_and_grads(
        tcfg, tstate, _torch_batch(b), torch.from_numpy(bg), 3,
        wrt=grid_names)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ssim"]),
                               float(jmetrics["ssim"]), atol=2e-5)
    # the regularizers are most of this loss: it is well above the plain one
    assert float(metrics["loss"]) > 2 * float(metrics["rgb_l1"])
    want = _port_leaves(jg, tcfg.dcfg)
    for name in grid_names:
        _assert_grads_close(grads[name].numpy(), want[name], name)


def test_state_helpers_and_eval_step(rng):
    from langsplat4d_torch.train import trainstate as TT
    jstate, jd = _jax_state(rng)
    jcfg, tcfg = _configs("fine-lang", jd)
    tstate = train_state_from_jax(jstate, tcfg.dcfg, device="cpu")
    b = _batch(rng, 1)
    tb = _torch_batch(b)

    before = {n: p.detach().clone() for n, p in tstate.leaves().items()}
    cam = TR.CameraParams(*[t[0] for t in tb.cams])
    out = TS.eval_step(tcfg, tstate, cam, tb.times[0], torch.zeros(3), 3)
    jcam = jax.tree.map(lambda x: x[0], b["cams"])
    want = JS.eval_step(jcfg, jstate, jcam, jnp.asarray(b["times"][0]),
                        jnp.zeros(3), 3)
    # 5e-4: the repo's bound between two programs (tests/test_parallel.py);
    # the depth channel holds values of ~5, where 3e-5 is a few ulp
    for key in ("render", "language_feature_image", "depth"):
        assert not out[key].requires_grad
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   atol=5e-4, err_msg=key)
    for n, p in tstate.leaves().items():        # evaluation changes nothing
        assert torch.equal(p, before[n]), n

    tstate.max_radii2d += 3.0
    tstate.xyz_gradient_accum += 1.0
    tstate.denom += 2.0
    tstate.deformation_accum += 4.0
    TT.reset_densification_stats(tstate)
    for name in ("max_radii2d", "xyz_gradient_accum", "denom",
                 "deformation_accum"):
        assert float(getattr(tstate, name).abs().max()) == 0.0, name
    tstate.active_sh_degree = 2
    assert TT.one_up_sh_degree(tstate, 3).active_sh_degree == 3
    assert TT.one_up_sh_degree(tstate, 3).active_sh_degree == 3


def _compact_inputs(rng, b):
    imgs = rng.integers(0, 256, size=(b, 3, H, W), dtype=np.uint8)
    segs = rng.integers(-1, 5, size=(b, H, W)).astype(np.int32)
    tables = [rng.normal(size=(5 + i, 3)).astype(np.float32)
              for i in range(b)]
    return imgs, segs, tables


def test_materialize_batch_matches_jax(rng):
    imgs, segs, tables = _compact_inputs(rng, 2)
    tabs = np.stack([np.pad(t, ((0, 6 - len(t)), (0, 0))) for t in tables])
    want = JS.materialize_batch(JS.Batch(
        cams=None, times=None, gt_images=jnp.asarray(imgs), gt_lang=None,
        lang_mask=None, gt_seg=jnp.asarray(segs),
        gt_tables=jnp.asarray(tabs)))
    got = TS.materialize_batch(TS.Batch(
        cams=None, times=None, gt_images=torch.from_numpy(imgs),
        gt_lang=None, lang_mask=None, gt_seg=torch.from_numpy(segs),
        gt_tables=torch.from_numpy(tabs)))
    assert got.gt_seg is None and got.gt_tables is None
    for f in ("gt_images", "gt_lang", "lang_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_train_step_packed_equals_train_step(rng):
    jstate, jd = _jax_state(rng)
    _, tcfg = _configs("fine-lang", jd)
    b = _batch(rng, 2)
    imgs, segs, tables = _compact_inputs(rng, 2)
    bg = torch.zeros(3)
    s1 = train_state_from_jax(jstate, tcfg.dcfg, device="cpu")
    s2 = copy.deepcopy(s1)
    tb = _torch_batch(b)
    tabs = np.stack([np.pad(t, ((0, 6 - len(t)), (0, 0))) for t in tables])
    batch = tb._replace(gt_images=torch.from_numpy(imgs), gt_lang=None,
                        lang_mask=None, gt_seg=torch.from_numpy(segs),
                        gt_tables=torch.from_numpy(tabs))
    out1 = TS.train_step(tcfg, s1, batch, bg, 7, 3)
    cams = [TR.CameraParams(*[t[i].numpy() for t in tb.cams])
            for i in range(2)]
    packed = TS.pack_cam_rows(cams, b["times"], 7)
    want_rows = JS.pack_cam_rows(cams, b["times"], 7)
    np.testing.assert_array_equal(packed, want_rows)
    assert packed.shape == (2, TS.PACKED_CAM_WIDTH)
    out2 = TS.train_step_packed(
        tcfg, s2, packed, [torch.from_numpy(i) for i in imgs],
        [torch.from_numpy(s) for s in segs],
        [torch.from_numpy(t) for t in tables], bg, 3)
    assert float(out1[1]["loss"]) == float(out2[1]["loss"]) > 0
    for a, c in zip(out1[2:], out2[2:]):
        assert torch.equal(a, c)
    l1, l2 = s1.leaves(), s2.leaves()
    for name in l1:
        assert torch.equal(l1[name], l2[name]), name
    assert not torch.equal(l1["language_feature"],
                           torch.from_numpy(
                               np.asarray(jstate.params["language_feature"])))
