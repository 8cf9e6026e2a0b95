"""Losses and image metrics, JAX vs the port, on the same numpy images.
Tolerance 1e-5 relative (fp32 means of a few thousand terms in two
frameworks); SSIM 2e-5 absolute (two 11-tap convolutions each side)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.train import losses as JL
from langsplat4d_torch.train import losses as TL


def _pair(rng, shape):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr"])
def test_pointwise_losses(rng, name):
    a, b = _pair(rng, (2, 3, 24, 40))
    want = float(getattr(JL, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(TL, name)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_psnr_masked(rng):
    a, b = _pair(rng, (3, 24, 40))
    mask = (rng.uniform(size=(1, 24, 40)) > 0.4).astype(np.float32)
    want = float(JL.psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)))
    got = float(TL.psnr(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cos_loss(rng):
    a = rng.normal(size=(2, 24, 40, 3)).astype(np.float32)
    b = rng.normal(size=(2, 24, 40, 3)).astype(np.float32)
    want = float(JL.cos_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(TL.cos_loss(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 24, 40), (2, 3, 17, 9)])
def test_ssim_and_its_gradient(rng, shape):
    """17x9 is narrower than the 11-tap window: SAME zero padding on both
    sides."""
    a, b = _pair(rng, shape)
    want = float(JL.ssim(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = TL.ssim(ta, torch.from_numpy(b))
    np.testing.assert_allclose(float(got.detach()), want, atol=2e-5)
    import jax
    want_g = jax.grad(lambda x: JL.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    got.backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_g),
                               rtol=1e-3, atol=1e-6)
