"""The language autoencoder, JAX package vs the port: forward, encode and
decode of the AE and the VAE, BatchNorm in training mode, checkpoints both
ways, and the train and export CLIs on the same seeded features."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.ae import model as JM
from langsplat4d_torch.ae import model as TM
from langsplat4d_torch.interop import ae_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_AE = os.path.join(REPO, "tests", "fixtures", "golden_quality",
                         "ae_best_ckpt.pth")
TOL = 1e-5
# (encoder, decoder, feature width): the golden checkpoint's, and the
# reference's full width
DIMS = [([8, 3], [8, 16], 16),
        ([256, 128, 64, 32, 3], [16, 32, 64, 128, 256, 256, 512], 512)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_ae(enc, dec, feat, seed=0, stats=True):
    """A JAX AE from a seed, its BatchNorm stats and affine moved off their
    defaults so that eval mode reads them."""
    p = JM.init_ae(jax.random.PRNGKey(seed), enc, dec, feat)
    rng = np.random.default_rng(seed + 100)
    if stats:
        for layer in p["encoder"]:
            if "bn" in layer:
                n = layer["bn"]["mean"].shape[0]
                f32 = jnp.float32
                layer["bn"] = {
                    "gamma": jnp.asarray(rng.uniform(0.5, 1.5, n), f32),
                    "beta": jnp.asarray(rng.normal(0, 0.1, n), f32),
                    "mean": jnp.asarray(rng.normal(0, 0.1, n), f32),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, n), f32)}
    return p


@pytest.mark.parametrize("enc,dec,feat", DIMS)
def test_ae_forward_encode_decode_match_jax(enc, dec, feat):
    p = _jax_ae(enc, dec, feat)
    model = ae_from_numpy(_np(p), device="cpu")
    x = np.random.default_rng(1).normal(size=(40, feat)).astype(np.float32)
    z_j, _ = JM.encode(p, jnp.asarray(x))
    with torch.no_grad():
        z_t = model.encode(torch.from_numpy(x))
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=TOL)
        np.testing.assert_allclose(
            model.decode(z_t).numpy(),
            np.asarray(JM.decode(p, z_j)), atol=TOL)
        out_j, _ = JM.forward(p, jnp.asarray(x))
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   np.asarray(out_j), atol=TOL)


def test_vae_forward_encode_decode_match_jax():
    enc, dec, feat, latent = [16, 8, 6], [8, 16, 32], 32, 4
    p = JM.init_vae(jax.random.PRNGKey(3), enc, dec, latent, feat)
    model = ae_from_numpy(_np(p), device="cpu")
    assert isinstance(model, TM.VanillaVAE)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(30, feat)).astype(np.float32)
    eps = rng.normal(size=(30, latent)).astype(np.float32)
    mu_j, lv_j, _ = JM.vae_encode(p, jnp.asarray(x))
    from langsplat4d.core.transforms import safe_normalize
    z_j = safe_normalize(jnp.asarray(eps) * jnp.exp(0.5 * lv_j) + mu_j)
    with torch.no_grad():
        recon, mu, lv = model(torch.from_numpy(x), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), atol=TOL)
    np.testing.assert_allclose(recon.numpy(),
                               np.asarray(JM.vae_decode(p, z_j)), atol=TOL)
    loss_j = JM.vae_loss(JM.vae_decode(p, z_j), jnp.asarray(x), mu_j, lv_j,
                         0.1)
    loss_t = TM.vae_loss(recon, torch.from_numpy(x), mu, lv, 0.1)
    for a, b in zip(loss_t, loss_j):
        np.testing.assert_allclose(float(a), float(b), rtol=TOL)
    # the reparameterisation from a generator: unit rows of the latent width
    g = torch.Generator().manual_seed(0)
    z = TM.VanillaVAE.reparameterize(mu, lv, generator=g)
    assert z.shape == (30, latent)
    np.testing.assert_allclose(z.norm(dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("vae", [False, True])
def test_batchnorm_training_step_matches_jax(vae):
    """nn.BatchNorm1d in training mode: the biased batch variance to
    normalise, the unbiased one into the running stats, momentum 0.1, eps
    1e-5, as the JAX package's `_batchnorm`."""
    enc, dec, feat = [16, 8, 3], [8, 16, 24], 24
    if vae:
        p = JM.init_vae(jax.random.PRNGKey(5), enc, dec, 4, feat)
    else:
        p = _jax_ae(enc, dec, feat, seed=5)
    model = ae_from_numpy(_np(p), device="cpu").train()
    x = np.random.default_rng(4).normal(size=(13, feat)).astype(np.float32)
    if vae:
        mu_j, lv_j, new = JM.vae_encode(p, jnp.asarray(x), train=True)
        mu_t, lv_t = model.encode(torch.from_numpy(x))
        got, want = [mu_t, lv_t], [mu_j, lv_j]
    else:
        out_j, new = JM.forward(p, jnp.asarray(x), train=True)
        got, want = [model(torch.from_numpy(x))], [out_j]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL)
    bns = [m for m in model.encoder if isinstance(m, torch.nn.BatchNorm1d)]
    jbns = [l["bn"] for l in new["encoder"] if "bn" in l]
    assert len(bns) == len(jbns) == 2
    for m, b in zip(bns, jbns):
        np.testing.assert_allclose(m.running_mean.numpy(),
                                   np.asarray(b["mean"]), atol=TOL)
        np.testing.assert_allclose(m.running_var.numpy(),
                                   np.asarray(b["var"]), atol=TOL)


@pytest.mark.parametrize("vae", [False, True])
def test_checkpoints_interchange(tmp_path, vae):
    """The JAX package's reference-layout state dict loads into the port
    with strict=True and gives the same numbers as ae_from_numpy; the port's
    checkpoint reads back in the JAX package."""
    enc, dec, feat = [16, 8, 3], [8, 16, 32], 32
    p = (JM.init_vae(jax.random.PRNGKey(7), enc, dec, 5, feat) if vae
         else _jax_ae(enc, dec, feat, seed=7))
    path = str(tmp_path / "jax.pth")
    JM.save_ckpt(path, p)
    model = TM.load_ckpt(path, enc, dec, feat, device="cpu")
    direct = ae_from_numpy(_np(p), device="cpu")
    assert type(model) is type(direct)
    for k, v in direct.state_dict().items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    back = str(tmp_path / "port.pth")
    TM.save_ckpt(back, model)
    q = JM.load_ckpt(back, enc, dec, feat)
    for a, b in zip(jax.tree_util.tree_leaves(q),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = np.random.default_rng(8).normal(
        size=(7, 5 if vae else 3)).astype(np.float32)
    dec_j = JM.vae_decode if vae else JM.decode
    with torch.no_grad():
        np.testing.assert_allclose(model.decode(torch.from_numpy(x)).numpy(),
                                   np.asarray(dec_j(q, jnp.asarray(x))),
                                   atol=TOL)


def test_golden_checkpoint_loads_strictly():
    model = TM.load_ckpt(GOLDEN_AE, [8, 3], [8, 16], 16, device="cpu")
    assert isinstance(model, TM.Autoencoder) and not model.training
    with pytest.raises(RuntimeError):
        TM.load_ckpt(GOLDEN_AE, [8, 3], [8, 8, 16], 16, device="cpu")


def _features(root, rng, n_files=3, rows=(70, 60, 75), width=16):
    d = os.path.join(root, "language_features")
    os.makedirs(d)
    for i in range(n_files):
        f = rng.normal(size=(rows[i], width)).astype(np.float32)
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
        np.save(os.path.join(d, f"{i + 1:06d}_f.npy"), f)
        np.save(os.path.join(d, f"{i + 1:06d}_s.npy"),
                rng.integers(-1, rows[i], size=(4, 6, 8)).astype(np.int16))


def test_train_and_export_clis_match_jax(tmp_path, monkeypatch):
    """Two epochs of `ae.train` through both CLIs on 205 seeded rows (three
    full batches of 64 and a tail of 13 per epoch) from the same initial
    weights: the JAX CLI's, carried across by replacing the port's
    `init_model`. The final parameters agree within rtol 1e-3 / atol 1e-5
    (Adam turns rounding-level gradient differences into steps of up to the
    learning rate); each CLI's best_ckpt.pth loads in the other package;
    `ae.test` exports within 1e-5 on the same checkpoint."""
    from langsplat4d.ae import test as j_test
    from langsplat4d.ae import train as j_train
    from langsplat4d_torch.ae import test as t_test
    from langsplat4d_torch.ae import train as t_train
    scene = str(tmp_path / "scene")
    _features(scene, np.random.default_rng(11))
    enc, dec, feat, seed = [8, 3], [8, 16], 16, 3
    common = ["--dataset_path", scene, "--encoder_dims", "8", "3",
              "--decoder_dims", "8", "16", "--feature_dims", "16",
              "--hidden_dims", "3"]
    train = common + ["--num_epochs", "2", "--eval_from_epoch", "0",
                      "--lr", "1e-2", "--seed", str(seed)]
    j_dir, t_dir = str(tmp_path / "ckpt_jax"), str(tmp_path / "ckpt_port")
    j_train.main(train + ["--model_name", "ae", "--ckpt_dir", j_dir])
    init = _np(JM.init_ae(jax.random.PRNGKey(seed), enc, dec, feat))
    monkeypatch.setattr(t_train, "init_model",
                        lambda args, use_vae: ae_from_numpy(init,
                                                            device="cpu"))
    best = t_train.main(train + ["--model_name", "ae", "--ckpt_dir", t_dir,
                                 "--device", "cpu"])
    assert np.isfinite(best) and best < 100
    j_ckpt = os.path.join(j_dir, "ae", "best_ckpt.pth")
    t_ckpt = os.path.join(t_dir, "ae", "best_ckpt.pth")
    j_sd = torch.load(j_ckpt, weights_only=True)
    t_sd = torch.load(t_ckpt, weights_only=True)
    assert sorted(j_sd) == sorted(t_sd)
    # The bias of the Linear that feeds the BatchNorm has no gradient (the
    # norm subtracts the batch mean), so both packages' Adam walks it on
    # rounding noise, each step up to `cap` learning rates either way, and
    # the norm's running mean follows it. Those two leaves are held to that
    # walk: 2 x 8 steps x cap x lr. Every other leaf: rtol 1e-3 / atol 1e-5.
    steps, lr = 2 * 4, 1e-2
    cap = max(np.sqrt(sum(((1 - 0.9) * 0.9 ** k / (1 - 0.9 ** t)) ** 2
                          / ((1 - 0.999) * 0.999 ** k / (1 - 0.999 ** t))
                          for k in range(t))) for t in range(1, steps + 1))
    noise = ("encoder.0.bias", "encoder.1.running_mean")
    for k in j_sd:
        if k in noise:
            np.testing.assert_allclose(t_sd[k].numpy(), j_sd[k].numpy(),
                                       rtol=0, atol=2 * steps * cap * lr,
                                       err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t_sd[k].numpy(), j_sd[k].numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=k)
    # each package reads the other's checkpoint
    TM.load_ckpt(j_ckpt, enc, dec, feat, device="cpu")
    JM.load_ckpt(t_ckpt, enc, dec, feat)

    # the export, through both CLIs, of the JAX CLI's checkpoint
    exp = common + ["--model_name", "ae", "--ckpt_dir", j_dir]
    j_test.main(exp + ["--language_name", "language_features",
                       "--output_name", "jax"])
    t_test.main(exp + ["--language_name", "language_features",
                       "--output_name", "port", "--device", "cpu"])
    jx = sorted(glob.glob(os.path.join(
        scene, "language_features-jax_dim3", "*.npy")))
    tx = sorted(glob.glob(os.path.join(
        scene, "language_features-port_dim3", "*.npy")))
    assert [os.path.basename(f) for f in jx] == [
        os.path.basename(f) for f in tx] and len(jx) == 6
    for a, b in zip(jx, tx):
        if a.endswith("_s.npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            np.testing.assert_allclose(np.load(b), np.load(a), atol=TOL)
    # the default output name
    t_test.main(exp + ["--device", "cpu"])
    assert len(glob.glob(os.path.join(
        scene, "language_features_dim3", "*_f.npy"))) == 3


def test_vae_cli_exports_unit_latents(tmp_path, monkeypatch):
    """use_vae=t: the port trains a VanillaVAE and exports the L2-normalised
    reparameterised sample of its latent width (its noise is the port's
    generator's, so the values are not the JAX package's)."""
    from langsplat4d_torch.ae import test as t_test
    from langsplat4d_torch.ae import train as t_train
    monkeypatch.setenv("use_vae", "t")
    scene = str(tmp_path / "scene")
    _features(scene, np.random.default_rng(12), width=32)
    common = ["--dataset_path", scene, "--model_name", "vae",
              "--encoder_dims", "16", "8", "3", "--decoder_dims", "8", "32",
              "--feature_dims", "32", "--latent_dim", "4",
              "--ckpt_dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    t_train.main(common + ["--num_epochs", "3", "--eval_from_epoch", "1"])
    ckpt = str(tmp_path / "ckpt" / "vae" / "best_ckpt.pth")
    assert isinstance(TM.load_ckpt(ckpt, [16, 8, 3], [8, 32], device="cpu"),
                      TM.VanillaVAE)
    JM.load_ckpt(ckpt, [16, 8, 3], [8, 32], 32)
    out = t_test.main(common)
    f = np.load(os.path.join(out, "000001_f.npy"))
    assert f.shape == (70, 4)
    np.testing.assert_allclose(np.linalg.norm(f, axis=-1), 1.0, atol=1e-5)


def test_a_batch_of_one_raises_in_training():
    """A batch of one row in training mode (the name is from when it
    raised, as nn.BatchNorm1d does): the port's BatchNorm normalises it as
    the JAX package's `_batchnorm` does (langsplat4d/ae/model.py:45-58), to
    0 before the affine, with the running variance taking var * n /
    max(n - 1, 1) = 0. The output and every running statistic against
    `JM.forward(..., train=True)`: 1e-6 (one fp32 row through the same
    ops; the decoder's normalisation rounds in another order)."""
    p = _jax_ae([8, 3], [8, 16], 16)
    model = ae_from_numpy(_np(p), device="cpu").train()
    x = np.random.default_rng(3).normal(size=(1, 16)).astype(np.float32)
    out_t = model(torch.from_numpy(x))
    out_j, new_p = JM.forward(p, jnp.asarray(x), train=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    bns = [m for m in model.encoder if isinstance(m, torch.nn.BatchNorm1d)]
    jbns = [layer["bn"] for layer in new_p["encoder"] if "bn" in layer]
    assert len(bns) == len(jbns) == 1
    for bn, jbn in zip(bns, jbns):
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(jbn["mean"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(jbn["var"]), rtol=0, atol=1e-6)
        assert int(bn.num_batches_tracked) == 1
    assert set(model.state_dict()) == set(
        ae_from_numpy(_np(p), device="cpu").state_dict())
    with torch.no_grad():
        assert torch.isfinite(model.eval()(torch.from_numpy(x))).all()
