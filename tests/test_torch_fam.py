"""The port's FAM attention (plain version and dispatcher) against the JAX
formulation and the JAX package's Pallas kernel in interpret mode."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.ops.fam import fam_attention as fam_xla
from tcvom_tpu.ops.fam_pallas import _fam_pallas_fwd
from tcvom_tpu_torch.ops import fam as TF
from tcvom_tpu_torch.ops import fam_kernel

SHAPES = [((2, 8, 16, 8), 3), ((1, 16, 24, 32), 7), ((2, 16, 24, 256), 7)]


def _inputs(rng, shape):
    b, h, w, c = shape
    q = rng.randn(b, h, w, c).astype(np.float32)
    k = rng.randn(b, h, w, c).astype(np.float32)
    mask = (rng.rand(b, h, w, 1) > 0.4).astype(np.float32)
    return q, k, mask


@pytest.mark.parametrize("shape,window", SHAPES)
def test_fam_ref_matches_jax_f32(rng, shape, window):
    q, k, mask = _inputs(rng, shape)
    want_out, want_lg = fam_xla(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(mask), window)
    want_mxu2, _ = _fam_pallas_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(mask), window, interpret=True,
                                   mxu2=True, need_logits=False)
    got_out, got_lg = TF.fam_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(mask),
        window)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), atol=1e-5)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_mxu2),
                               atol=1e-5)


def test_fam_ref_bf16_matches_pallas_mxu2(rng):
    """bf16 against the mxu2 kernel, which accumulates in f32 as the port
    does; the tolerance covers bf16 rounding of the inputs' products and
    of the kernel's bf16 attention weights (2^-8 relative)."""
    q, k, mask = _inputs(rng, (1, 16, 24, 32))
    bf = jnp.bfloat16
    want, _ = _fam_pallas_fwd(jnp.asarray(q, bf), jnp.asarray(k, bf),
                              jnp.asarray(mask, bf), 7, interpret=True,
                              mxu2=True, need_logits=False)
    tb = torch.bfloat16
    got, _ = TF.fam_attention_ref(torch.from_numpy(q).to(tb),
                                  torch.from_numpy(k).to(tb),
                                  torch.from_numpy(mask).to(tb), 7)
    assert got.dtype == tb
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2)


def test_fam_dispatch_cpu_takes_plain_version(rng):
    q, k, mask = (torch.from_numpy(a) for a in _inputs(rng, (2, 8, 16, 8)))
    want_out, want_lg = TF.fam_attention_ref(q, k, mask, 3)
    out, lg = TF.fam_attention(q, k, mask, 3)
    assert lg is None
    assert torch.equal(out, want_out)
    out, lg = TF.fam_attention(q, k, mask, 3, need_logits=True)
    assert torch.equal(out, want_out) and torch.equal(lg, want_lg)


def test_fam_window_rejects_cpu_tensor():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fam_kernel.fam_window(q, q, q[..., :1].contiguous(), 3)
