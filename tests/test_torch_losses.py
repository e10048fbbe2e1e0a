"""The port's matting losses against tcvom_tpu/ops/losses.py, values and
(for the pyramid losses) gradients, on the CPU."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.ops import losses as JL
from tcvom_tpu_torch.ops import losses as TL

SHAPE = (2, 64, 96, 3)        # 5 pyramid levels need H, W divisible by 16


def _pair(rng, shape=SHAPE):
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def _mask(rng, shape=SHAPE):
    return (rng.rand(*shape[:-1], 1) > 0.6).astype(np.float32)


@pytest.mark.parametrize("masked,normalize", [
    (False, True), (False, False), (True, True), (True, False)])
def test_l1_mask_matches_jax(rng, masked, normalize):
    x, y = _pair(rng)
    m = _mask(rng) if masked else None
    want = JL.l1_mask(jnp.asarray(x), jnp.asarray(y),
                      None if m is None else jnp.asarray(m),
                      normalize=normalize)
    got = TL.l1_mask(torch.from_numpy(x), torch.from_numpy(y),
                     None if m is None else torch.from_numpy(m),
                     normalize=normalize)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_l1_mask_empty_mask_takes_the_clamped_denominator(rng):
    x, y = _pair(rng)
    m = np.zeros(SHAPE[:-1] + (1,), np.float32)
    got = TL.l1_mask(torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(m))
    assert got.item() == 0.0
    np.testing.assert_allclose(
        got.item(), float(JL.l1_mask(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(m))), rtol=1e-5)


@pytest.mark.parametrize("name", ["l1_grad", "l1_grad_masked",
                                  "exclusion_loss", "lap_loss",
                                  "sparsity_loss"])
def test_loss_value_matches_jax(rng, name):
    x, y = _pair(rng)
    m = _mask(rng)
    if name == "l1_grad_masked":
        want = JL.l1_grad(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
        got = TL.l1_grad(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(m))
    elif name == "sparsity_loss":
        want = JL.sparsity_loss(jnp.asarray(x), jnp.asarray(m))
        got = TL.sparsity_loss(torch.from_numpy(x), torch.from_numpy(m))
    else:
        want = getattr(JL, name)(jnp.asarray(x), jnp.asarray(y))
        got = getattr(TL, name)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_exclusion_loss_per_sample_reduction(rng, normalize):
    """Leading clip dims stay per sample: [B, S, H, W, C]."""
    x, y = _pair(rng, (2, 3, 32, 32, 3))
    want = JL.exclusion_loss(jnp.asarray(x), jnp.asarray(y),
                             normalize=normalize)
    got = TL.exclusion_loss(torch.from_numpy(x), torch.from_numpy(y),
                            normalize=normalize)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["lap_loss", "exclusion_loss"])
def test_pyramid_loss_gradients_match_jax(rng, name):
    x, y = _pair(rng)
    want = jax.grad(lambda a: getattr(JL, name)(a, jnp.asarray(y)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(getattr(TL, name)(xt, torch.from_numpy(y)),
                                 xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
