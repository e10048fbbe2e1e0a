"""The port's FAM attention (plain version, dispatcher and autograd
Function) against the JAX formulation and the JAX package's Pallas kernels
in interpret mode."""
import unittest.mock as mock

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


@pytest.mark.parametrize("wrapper", ["fam_window", "fam_window_logits"])
def test_fam_window_rejects_cpu_tensor(wrapper):
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fam_kernel, wrapper)(q, q, q[..., :1].contiguous(), 3)


@pytest.mark.parametrize("mxu", [False, True], ids=["C_fam_kernel",
                                                    "D_fam_kernel_mxu"])
@pytest.mark.parametrize("window", [3, 7])
def test_fam_logits_match_pallas_training_kernels(rng, mxu, window):
    """Out and logits of the plain version (the logits kernel's oracle)
    against the two logits-writing Pallas kernels the CUDA kernel
    replaces: _fam_kernel (C) and _fam_kernel_mxu (D)."""
    q, k, mask = _inputs(rng, (2, 16, 24, 128))
    want_out, want_lg = _fam_pallas_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask), window,
        interpret=True, mxu=mxu, need_logits=True)
    got_out, got_lg = TF.fam_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(mask),
        window, need_logits=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                               atol=1e-5)


@pytest.mark.parametrize("through", ["plain", "function"])
def test_fam_vjp_matches_jax(rng, through):
    """dq, dk with both cotangents (d_out, d_logits) against jax.vjp of
    the JAX formulation, through the plain version's autograd and through
    the autograd Function run with the plain forward."""
    window = 5
    q, k, mask = _inputs(rng, (2, 8, 12, 16))
    d_out = rng.randn(*q.shape).astype(np.float32)
    d_lg = rng.randn(*q.shape[:3], window * window).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: fam_xla(a, b, jnp.asarray(mask), window),
                     jnp.asarray(q), jnp.asarray(k))
    want = vjp((jnp.asarray(d_out), jnp.asarray(d_lg)))
    qt = torch.from_numpy(q).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    if through == "plain":
        out, lg = TF.fam_attention_ref(qt, kt, torch.from_numpy(mask),
                                       window)
    else:
        out, lg = TF.FamAttention.apply(qt, kt, torch.from_numpy(mask),
                                        window, TF.fam_attention_ref)
    got = torch.autograd.grad(
        (out, lg), (qt, kt), (torch.from_numpy(d_out), torch.from_numpy(d_lg)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("need_logits", [False, True])
def test_fam_dispatch_off_cpu_keeps_the_gradient(need_logits):
    """Off the CPU, a call under autograd goes through the Function (the
    logits kernel forward, the plain VJP backward), never the inference
    kernel, whose output has no grad_fn. Meta tensors stand in for the
    card, with the plain version in place of the kernel."""
    q, k = (torch.randn(1, 4, 6, 8, device="meta", requires_grad=True)
            for _ in range(2))
    m = torch.ones(1, 4, 6, 1, device="meta")
    launched = []

    def logits_kernel(*args):
        launched.append("fam_window_logits")
        return TF.fam_attention_ref(*args)

    def inference_kernel(*args):
        raise AssertionError("the inference kernel drops the gradient")

    with mock.patch.object(fam_kernel, "fam_window_logits", logits_kernel), \
            mock.patch.object(fam_kernel, "fam_window", inference_kernel):
        out, lg = TF.fam_attention(q, k, m, 3, need_logits=need_logits)
        dq, dk = torch.autograd.grad(out.sum(), (q, k))
    assert launched == ["fam_window_logits"]
    assert type(out.grad_fn).__name__ == "FamAttentionBackward"
    assert (lg is not None) == need_logits
    assert dq.shape == q.shape and dk.shape == k.shape
