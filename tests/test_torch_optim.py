"""Learning-rate groups, the trainable set per stage and the Adam update,
JAX vs the port, from the same numpy values.

The JAX `adam_update` keeps one global step count: a leaf frozen for the
first steps is bias-corrected with the global count when it starts to train
(`torch.optim.Adam` would count per parameter). The port is held to the JAX
function, including that case. Tolerances: learning rates 5e-6 relative (JAX
takes exp of the log-lerp in float32, whose argument near -9 carries an ulp
of 1e-6; the port computes in Python floats); parameters after several Adam
steps rtol 1e-5 / atol 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.config import OptimizationConfig
from langsplat4d.core.transforms import expon_lr as j_expon_lr
from langsplat4d.field.deformation import (DeformConfig as JDeformConfig,
                                           init_deform_params)
from langsplat4d.train import optim as JO
from langsplat4d_torch.core.transforms import expon_lr
from langsplat4d_torch.field.deformation import DeformConfig, DeformNetwork
from langsplat4d_torch.interop import params_from_jax
from langsplat4d_torch.train import optim as TO

SMALL = dict(net_width=16, posebase_pe=2, kplanes_out_dim=4,
             kplanes_resolution=(8, 8, 8, 4), multires=(1,), lang_dim=3)
GAUSS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
         "language_feature")


@pytest.mark.parametrize("step", [0, 1, 137, 5000, 20_000, 30_000])
def test_expon_lr(step):
    kw = dict(lr_delay_mult=0.01, max_steps=20_000)
    want = float(j_expon_lr(step, 1.6e-4, 1.6e-6, **kw))
    np.testing.assert_allclose(expon_lr(step, 1.6e-4, 1.6e-6, **kw), want,
                               rtol=5e-6)
    np.testing.assert_allclose(
        float(expon_lr(torch.tensor(step), 1.6e-4, 1.6e-6, **kw)), want,
        rtol=1e-5)
    kw = dict(lr_delay_steps=100, lr_delay_mult=0.1, max_steps=1000)
    np.testing.assert_allclose(expon_lr(step, 1e-2, 1e-3, **kw),
                               float(j_expon_lr(step, 1e-2, 1e-3, **kw)),
                               rtol=5e-6)
    assert expon_lr(step, 0.0, 0.0) == 0.0


@pytest.mark.parametrize("iteration", [1, 4000])
def test_group_lrs(iteration):
    o = OptimizationConfig()
    want = JO.group_lrs(JO.LRConfig.from_optim(o, 2.0), iteration)
    got = TO.group_lrs(TO.LRConfig.from_optim(o, 2.0), iteration)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=5e-6,
                                   err_msg=k)


def _jax_params(rng):
    jd = JDeformConfig(**SMALL)
    params = {k: jnp.zeros((4, 3)) for k in GAUSS}
    params["deform"] = init_deform_params(jax.random.PRNGKey(0), jd)
    return params


def _port_names():
    net = DeformNetwork(DeformConfig(**SMALL))
    return list(GAUSS) + ["deform." + n for n, _ in net.named_parameters()]


def _by_port_name(params, tree):
    """A JAX pytree shaped like `params` (labels or bools at the leaves) ->
    {port leaf name: value}: every parameter is filled with its leaf index
    and sent through the bridge that maps the parameters themselves."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    values = treedef.flatten_up_to(tree)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(a), i, np.float32)
                  for i, a in enumerate(leaves)])
    out = {k: values[int(ids[k].ravel()[0])] for k in GAUSS}
    for k, v in params_from_jax(ids["deform"], DeformConfig(**SMALL)).items():
        out["deform." + k] = values[int(v.ravel()[0])]
    return out


def test_group_labels_match_jax(rng):
    params = _jax_params(rng)
    want = _by_port_name(params, JO.label_tree(params))
    names = _port_names()
    assert set(names) == set(want)
    for n in names:
        assert TO.group_of_leaf(n) == want[n], n
    assert {TO.group_of_leaf(n) for n in names} == {
        "grid", "deformation", *GAUSS}


@pytest.mark.parametrize("stage,joint,no_dlang", [
    ("coarse-base", False, True), ("coarse-lang", False, True),
    ("fine-base", False, True), ("fine-lang", False, False),
    ("fine-lang", False, True), ("fine-lang", True, False),
    ("fine-lang-discrete", False, False)])
def test_trainable_tree_matches_jax(rng, stage, joint, no_dlang):
    params = _jax_params(rng)
    kw = dict(include_feature=True, joint_train=joint, no_dlang=no_dlang)
    want = _by_port_name(params, JO.trainable_tree(params, stage, **kw))
    got = TO.trainable_tree(_port_names(), stage, **kw)
    assert got == want
    if stage == "fine-lang" and not joint and not no_dlang:
        on = {n for n, t in got.items() if t}
        assert "language_feature" in on and "xyz" not in on
        assert all(".lang_deform." in n for n in on - {"language_feature"})


def test_adam_matches_jax_with_late_unfrozen_leaf(rng):
    """Leaf "b" is frozen for three steps and trains for four: its first
    update is bias-corrected with the global step 4, not 1."""
    names = ("a", "b", "c")
    p0 = {n: rng.normal(size=(5, 3)).astype(np.float32) for n in names}
    gseq = [{n: rng.normal(size=(5, 3)).astype(np.float32) for n in names}
            for _ in range(7)]
    lrs = {"a": 0.01, "b": 0.003, "c": 0.01}

    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jopt = JO.adam_init(jp)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    topt = TO.adam_init(tp)
    for i, g in enumerate(gseq):
        train = {"a": True, "b": i >= 3, "c": False}
        jp, jopt = JO.adam_update(
            jp, {n: jnp.asarray(v) for n, v in g.items()}, jopt,
            {n: jnp.asarray(v, jnp.float32) for n, v in lrs.items()}, train)
        TO.adam_update(tp, {n: torch.from_numpy(v) for n, v in g.items()},
                       topt, lrs, train)
    assert int(jopt.step) == topt.step == 7
    np.testing.assert_array_equal(tp["c"].numpy(), p0["c"])
    for n in ("a", "b"):
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-7)
    for n in names:
        np.testing.assert_allclose(topt.m[n].numpy(), np.asarray(jopt.m[n]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(topt.v[n].numpy(), np.asarray(jopt.v[n]),
                                   rtol=1e-5, atol=1e-7)
    # and it is not what a per-parameter count would give
    ref = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))
    o = torch.optim.Adam([ref], lr=lrs["b"], eps=1e-15)
    for g in gseq[3:]:
        ref.grad = torch.from_numpy(g["b"])
        o.step()
    assert not np.allclose(ref.detach().numpy(), tp["b"].numpy(), rtol=1e-3,
                           atol=1e-5)


def test_adam_missing_gradient_is_a_zero_gradient(rng):
    """JAX differentiates every leaf and gives zeros where the loss does not
    reach one; autograd gives None there."""
    p0 = rng.normal(size=(4,)).astype(np.float32)
    g0 = rng.normal(size=(4,)).astype(np.float32)
    runs = []
    for second in (None, torch.zeros(4)):
        p = {"x": torch.from_numpy(p0.copy())}
        opt = TO.adam_init(p)
        TO.adam_update(p, {"x": torch.from_numpy(g0)}, opt, {"x": 0.1},
                       {"x": True})
        TO.adam_update(p, {"x": second}, opt, {"x": 0.1}, {"x": True})
        runs.append((p["x"].numpy(), opt.m["x"].numpy(), opt.v["x"].numpy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(runs[0][1], 0.1 * g0)      # the moments decayed
