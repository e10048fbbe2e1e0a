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


_MMA_TILE = (8, 8)      # query rows, columns of a block (Plan in the .cu)


def _mma_plan(window):
    """csrc/fam_window.cu's Plan<window // 2>: the halo a block stages, and
    the halo columns each warp's 16 rows meet (``cols``, padded to
    ``cols_pad`` for the k-steps of ``P . K``)."""
    r = window // 2
    th, tw = _MMA_TILE
    halo = (th + 2 * r, tw + 2 * r)
    cols = (2 * r + 2) * halo[1]
    return dict(halo=halo, cols=cols, cols_pad=-(-cols // 16) * 16)


@pytest.mark.parametrize("window", [1, 3, 5, 7, 9])
def test_fam_mma_plan(window):
    """The tensor-core kernel's plan: each warp's columns hold every
    neighbour of its 16 rows and pad to whole k-steps; the wrapper takes
    the window (the .cu holds the shared memory to 48 KB at compile
    time)."""
    fam_kernel.check_mma_window(window)
    plan = _mma_plan(window)
    r = window // 2
    assert plan["halo"] == (8 + 2 * r, 8 + 2 * r)
    assert plan["cols"] == (2 * r + 2) * (8 + 2 * r) >= window * window
    assert plan["cols_pad"] % 16 == 0 and plan["cols_pad"] - plan["cols"] < 16


@pytest.mark.parametrize("window", [0, 2, 8, 11, 13])
def test_fam_mma_plan_refuses_windows(window):
    with pytest.raises(ValueError, match="odd windows up to 9"):
        fam_kernel.check_mma_window(window)


def _tf32_split(x):
    """csrc/fam_window.cu's split_tf32 in torch, as the tensor core reads
    the two terms: big, x rounded to tf32 to nearest with ties away from
    zero (``cvt.rna.tf32.f32``: add half of the low 13 bits' range to the
    sign-magnitude bit pattern, clear them), and small, the tf32 part of
    the exact f32 x - big (the tensor core ignores an operand's low 13
    bits). Returns (big, small), f32 tensors."""
    def bits(v):
        return v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def f32(u):
        return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(
            torch.int32).view(torch.float32)

    big = f32((bits(x) + 0x1000) & 0xFFFFE000)
    return big, f32(bits(x - big) & 0xFFFFE000)


def _mm_3xtf32(a, b):
    """``a @ b`` as the kernel's 3xTF32 products, the small terms first."""
    (ab, as_), (bb, bs) = _tf32_split(a), _tf32_split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _mma_tiling(q, k, mask, window, tf32=False):
    """The tensor-core kernel's algorithm in torch, tile by tile and warp by
    warp as csrc/fam_window.cu runs it: each warp's 16 rows against its
    halo columns, 128 bytes of channels (64 bf16, 32 f32) at a time, the
    band picked by the kernel's index arithmetic; the logits stored from
    the band by its ``dy * window + dx`` arithmetic. bf16 (default): the
    unnormalised weights rounded to bf16, divided by their f32 sum, out and
    logits rounded to bf16. ``tf32``: every product in 3xTF32, the weights
    f32. Returns (out, logits)."""
    b, h, w, c = q.shape
    plan = _mma_plan(window)
    r, (hh, hw) = window // 2, plan["halo"]
    th, tw = _MMA_TILE
    ty, tx = -(-h // th), -(-w // tw)
    chunk = 32 if tf32 else 64
    cp = -(-c // chunk) * chunk                 # zero channels past C
    mm = _mm_3xtf32 if tf32 else torch.matmul
    kp = torch.nn.functional.pad(k.float(), (0, cp - c, r, r + tx * tw - w,
                                             r, r + ty * th - h))
    qp = torch.nn.functional.pad(q.float(), (0, cp - c, 0, tx * tw - w,
                                             0, ty * th - h))
    out = torch.zeros(b, ty * th, tx * tw, cp)
    logits = torch.zeros(b, ty * th, tx * tw, window * window)
    i = torch.arange(16)[:, None]
    col = torch.arange(plan["cols_pad"])[None]
    dy, dx = col // hw - i // 8, col % hw - i % 8
    band = (col < plan["cols"]) & (dy >= 0) & (dy <= 2 * r) \
        & (dx >= 0) & (dx <= 2 * r)
    lidx = dy * window + dx
    # each row's band holds each neighbour exactly once
    for row in range(16):
        assert torch.equal(lidx[row][band[row]].sort().values,
                           torch.arange(window * window))
    brow, bcol = band.nonzero(as_tuple=True)
    for n in range(b):
        for y0 in range(0, ty * th, th):
            for x0 in range(0, tx * tw, tw):
                halo = kp[n, y0:y0 + hh, x0:x0 + hw].reshape(-1, cp)
                halo = torch.cat([halo, halo.new_zeros(
                    plan["cols_pad"] - plan["cols"], cp)])
                for wp in range(th // 2):
                    cols = halo[2 * wp * hw:2 * wp * hw + plan["cols_pad"]]
                    rows = qp[n, y0 + 2 * wp:y0 + 2 * wp + 2,
                              x0:x0 + tw].reshape(16, cp)
                    s = sum(mm(rows[:, c0:c0 + chunk],
                               cols[:, c0:c0 + chunk].T)
                            for c0 in range(0, cp, chunk))
                    lg = torch.zeros(16, window * window)
                    lg[brow, lidx[brow, bcol]] = s[brow, bcol] / c ** 0.5
                    s = s.masked_fill(~band, -torch.inf)
                    p = torch.exp((s - s.amax(1, keepdim=True)) / c ** 0.5)
                    if not tf32:
                        p = p.bfloat16().float()
                    o = torch.cat([mm(p, cols[:, c0:c0 + chunk])
                                   for c0 in range(0, cp, chunk)], 1)
                    o = o / p.sum(1, keepdim=True)
                    ys = slice(y0 + 2 * wp, y0 + 2 * wp + 2)
                    out[n, ys, x0:x0 + tw] = o.reshape(2, tw, cp)
                    logits[n, ys, x0:x0 + tw] = lg.reshape(2, tw, -1)
    m = mask.float()
    out, logits = out[:, :h, :w, :c] * m, logits[:, :h, :w] * m
    return (out, logits) if tf32 else (out.bfloat16(), logits.bfloat16())


@pytest.mark.parametrize("shape,window", [((2, 13, 21, 24), 3),
                                          ((1, 16, 24, 32), 7),
                                          ((1, 11, 9, 8), 9)])
def test_fam_mma_tiling_matches_jax(rng, shape, window):
    """The tiling and band arithmetic of the bf16 tensor-core kernel (which
    runs only on the card) against the JAX formulation, on bf16 inputs at
    ragged shapes; 2e-2 covers the bf16 weights and output."""
    q, k, mask = _inputs(rng, shape)
    tb = torch.bfloat16
    q, k, mask = (torch.from_numpy(a).to(tb) for a in (q, k, mask))
    want, _ = fam_xla(*(jnp.asarray(t.float().numpy()) for t in (q, k, mask)),
                      window)
    got, _ = _mma_tiling(q, k, mask, window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties", "exact"])
def test_tf32_split(rng, kind):
    """big + small gives x back within 2^-21 relative (the kernel's 3xTF32
    operands: big within half a tf32 ulp, 2^-11, and small cut to tf32),
    both tf32 (low 13 bits zero), big the nearest tf32 with ties away from
    zero; over normal draws, magnitudes 1e-30..1e30, exact ties and values
    tf32 holds exactly (zeros, powers of two)."""
    if kind == "normal":
        x = rng.randn(4096).astype(np.float32)
    elif kind == "wide":
        x = (np.sign(rng.randn(4096)) * 10.0 ** rng.uniform(-30, 30, 4096)
             ).astype(np.float32)
    elif kind == "ties":
        bits = (rng.randint(0x01000000, 0x7E000000, 4096).astype(np.uint32)
                & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
        bits[::2] |= np.uint32(0x80000000)
        x = bits.view(np.float32)
    else:
        x = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -100, -(2.0 ** 100),
                      1.5, 3.0 * 2.0 ** -20, 65504.0], np.float32)
    big, small = _tf32_split(torch.from_numpy(x))
    for v in (big, small):
        assert not (v.view(torch.int32) & 0x1FFF).any()
    xd = torch.from_numpy(x).double()
    err = (big.double() + small.double() - xd).abs()
    assert (err <= 2.0 ** -21 * xd.abs()).all()
    assert ((big.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all()
    if kind == "ties":      # away from zero: |big| > |x|, same sign
        assert (big.double().abs() > xd.abs()).all()
        assert (torch.sign(big) == torch.sign(torch.from_numpy(x))).all()
    if kind == "exact":
        assert torch.equal(big, torch.from_numpy(x)) and not small.any()


@pytest.mark.parametrize("shape,window", [((2, 13, 21, 24), 3),
                                          ((1, 16, 24, 32), 7),
                                          ((1, 11, 9, 8), 9),
                                          ((1, 9, 10, 300), 5)])
def test_fam_tf32_tiling_matches_jax(rng, shape, window):
    """The f32 kernels' tiling (3xTF32 products, f32 weights, 32-channel
    chunks, the last one ragged at C = 300) and their logits' band ->
    ``dy * window + dx`` arithmetic against the JAX formulation at ragged
    shapes, out and logits, at the f32 entries' 1e-5."""
    q, k, mask = _inputs(rng, shape)
    want_out, want_lg = fam_xla(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(mask), window)
    got_out, got_lg = _mma_tiling(*(torch.from_numpy(a) for a in (q, k, mask)),
                                  window, tf32=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), atol=1e-5)


@pytest.mark.parametrize("mxu", [False, True], ids=["C_fam_kernel",
                                                    "D_fam_kernel_mxu"])
def test_fam_tf32_tiling_matches_pallas_training_kernels(rng, mxu):
    """The same emulation against the two logits-writing Pallas kernels the
    f32 entries replace, in interpret mode (H, W multiples of 8 there);
    C = 40 leaves a ragged second chunk."""
    q, k, mask = _inputs(rng, (1, 16, 24, 40))
    want_out, want_lg = _fam_pallas_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask), 7,
        interpret=True, mxu=mxu, need_logits=True)
    got_out, got_lg = _mma_tiling(*(torch.from_numpy(a) for a in (q, k, mask)),
                                  7, tf32=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), atol=1e-5)


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
