"""The PyTorch port's ops against the JAX package's, on the CPU."""
import ast
import pathlib
import unittest.mock as mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models.layers import ws_standardize as ws_jax
from tcvom_tpu.ops import distance as JD
from tcvom_tpu.ops import edt_pallas as JEP
from tcvom_tpu.ops import image as JI
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.layers import ws_standardize as ws_torch
from tcvom_tpu_torch.ops import distance as TD
from tcvom_tpu_torch.ops import edt_kernel as TE
from tcvom_tpu_torch.ops import image as TI

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("op,args", [
    ("resize_bilinear", ((16, 24),)),          # 2x up
    ("resize_bilinear", ((5, 7),)),            # uneven down
    ("resize_bilinear", ((13, 29),)),          # uneven up
    ("resize_nearest", ((64, 96),)),           # integer up
    ("resize_nearest", ((3, 5),)),             # down
    ("max_pool", (3, 2, 1)),
    ("adaptive_avg_pool", (6,)),
    ("adaptive_avg_pool", (1,)),
])
def test_image_ops_match_jax(rng, op, args):
    # values in [0, 1), as images and post-activation features: the two
    # bilinear formulations round differently (separable vs four-tap), a
    # few ulps of the value
    x = rng.rand(2, 8, 12, 5).astype(np.float32)
    want = np.asarray(getattr(JI, op)(jnp.asarray(x), *args))
    got = _nhwc(getattr(TI, op)(_nchw(x), *args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("op,args", [
    ("avg_pool", (2, 2)), ("avg_pool", (8, 8)), ("avg_pool", (3, 1, 1)),
    ("unfold", (3,)), ("unfold", (7,)),
    ("image_gradient", ())])
def test_channels_last_ops_match_jax(rng, op, args):
    """The training stack's ops, channels-last with two leading dims."""
    x = rng.rand(2, 3, 16, 24, 2).astype(np.float32)
    want = getattr(JI, op)(jnp.asarray(x), *args)
    got = getattr(TI, op)(torch.from_numpy(x), *args)
    for g, w in zip(*((got, want) if op == "image_gradient"
                      else ((got,), (want,)))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def _trimask(rng, shape):
    m = np.zeros(shape, np.float32)
    m[..., 20:30, 10:18, :] = 1.0
    m[rng.rand(*shape) < 0.003] = 1.0
    return m


@pytest.mark.parametrize("radius", [0, 1, 6, 25])
def test_dilate_static_radius_matches_jax(rng, radius):
    m = _trimask(rng, (2, 48, 40, 1))
    want = np.asarray(JI.dilate_by_radius(jnp.asarray(m), radius))
    got = TI.dilate_by_radius(torch.from_numpy(m), radius).numpy()
    np.testing.assert_array_equal(got, want)


def test_dilate_per_sample_radius_matches_jax(rng):
    m = _trimask(rng, (4, 2, 48, 40, 1))
    radius = np.array([0, 1, 13, 25], np.int32)
    want = np.asarray(JI.dilate_by_radius(jnp.asarray(m), jnp.asarray(radius),
                                          max_radius=25))
    got = TI.dilate_by_radius(torch.from_numpy(m),
                              torch.from_numpy(radius)).numpy()
    np.testing.assert_array_equal(got, want)
    # the per-sample iterate equals the static two-pass form
    for i, r in enumerate(radius):
        np.testing.assert_array_equal(
            got[i], TI.dilate_by_radius(torch.from_numpy(m[i]), int(r)))


@pytest.mark.parametrize("shape", [(3, 3, 11, 64), (1, 1, 256, 32)])
def test_ws_standardize_matches_jax(rng, shape):
    w = rng.randn(*shape).astype(np.float32) * 0.1 + 0.02
    want = np.asarray(ws_jax(jnp.asarray(w)))
    got = ws_torch(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want,
                               atol=1e-6)


@pytest.mark.parametrize("r,w", [(200, 300), (130, 70)])
def test_edt_row_pass_ref_bit_exact_vs_pallas(rng, r, w):
    t = 32
    g2 = np.where(rng.rand(r, w) < 0.05, 0.0,
                  rng.randint(0, 3000, (r, w))).astype(np.float32)
    want = np.asarray(JEP.edt_row_pass_fused(jnp.asarray(g2), trunc=t,
                                             interpret=True))
    got = TE.edt_row_pass_ref(torch.from_numpy(g2), t).numpy()
    np.testing.assert_array_equal(got, want)
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        TE.edt_row_pass(torch.from_numpy(g2), t).numpy(), want)


@pytest.mark.parametrize("w", [1, 9, 100, 512, 960, 1920, 2305, 9216, 9217,
                               20000])
def test_edt_row_plan(w):
    """Segments of whole per-thread blocks, as even as they allow, at most
    1024 threads a block, and shared memory within the opt-in limit for
    every truncation a 256-output block took within 48 KB (T <= 5996)."""
    per = TE._PER
    for t in (0, 1, 256, 5996):
        seg, nseg, smem = TE.row_plan(w, t)
        assert seg % per == 0 and seg // per <= 1024
        assert nseg * seg >= w > (nseg - 1) * seg and seg - per < -(-w // nseg)
        assert smem == (seg + 2 * t + 3 * per) * 4 <= TE._MAX_SMEM


def _edt_sweep(g2: np.ndarray, t: int) -> np.ndarray:
    """csrc/edt_row.cu's sweep (its f32 form, which the DPX form equals on
    non-negative values) in numpy, segment by segment and thread by
    thread, with its register windows and running d^2; every read of the
    staged row is checked against the staging's bounds."""
    per = TE._PER
    r, w = g2.shape
    seg, nseg, smem = TE.row_plan(w, t)
    span = smem // 4
    out = np.full_like(g2, np.nan)

    def sweep(c):
        acc = [c(u) for u in range(per)]
        lw = [c(i - per) for i in range(2 * per - 1)]
        rw = [c(1 + i) for i in range(2 * per - 1)]
        d2, step, d0 = np.float32(1), np.float32(3), 1
        while d0 + per - 1 <= min(t, 4095):
            for dd in range(per):
                for u in range(per):
                    acc[u] = min(acc[u], min(lw[u - dd + per - 1],
                                             rw[u + dd]) + d2)
                d2, step = d2 + step, step + np.float32(2)
            lw = [c(i - d0 - 2 * per + 1) for i in range(per)] + lw[:per - 1]
            rw = rw[per:] + [c(d0 + per + i)
                             for i in range(per - 1, 2 * per - 1)]
            d0 += per
        for d in range(d0, t + 1):
            for u in range(per):
                acc[u] = min(acc[u], min(c(u - d), c(u + d))
                             + np.float32(d * d))
        return np.array(acc, np.float32)

    for row in range(r):
        for j0 in range(0, nseg * seg, seg):
            cols = j0 - t - per + np.arange(span)
            s = np.where((cols >= 0) & (cols < w),
                         g2[row, np.clip(cols, 0, w - 1)], np.float32(1e7))
            for first in range(0, seg, per):
                if j0 + first >= w:
                    continue

                def c(x, at=per + t + first):
                    assert 0 <= at + x < span
                    return s[at + x]

                res = sweep(c)
                n = min(per, w - j0 - first)
                out[row, j0 + first:j0 + first + n] = res[:n]
    return out


@pytest.mark.parametrize("r,w,t", [(3, 40, 20), (2, 9217, 3), (4, 7, 0),
                                   (2, 30, 1), (2, 50, 40)])
def test_edt_register_sweep_bit_exact(rng, r, w, t):
    """The CUDA kernel's blocking and sliding windows (which run only on
    the card), emulated, against the plain version: bit-exact."""
    g2 = np.where(rng.rand(r, w) < 0.05, 0.0,
                  rng.randint(0, 3000, (r, w))).astype(np.float32)
    want = TE.edt_row_pass_ref(torch.from_numpy(g2), t).numpy()
    np.testing.assert_array_equal(_edt_sweep(g2, t), want)


def test_edt_row_pass_cuda_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        TE.edt_row_pass_cuda(torch.zeros(4, 8), 2)


def test_edt_squared_bit_exact_vs_pallas_route(rng):
    h, w, t = 96, 160, 32
    seed = rng.rand(2, h, w) < 0.002
    seed[1, h // 2, w // 2] = True
    orig = JEP.edt_row_pass_fused
    with mock.patch.object(JEP, "edt_row_pass_fused",
                           lambda g2, trunc: orig(g2, trunc, interpret=True)):
        want = np.asarray(JD.edt_squared(jnp.asarray(seed), chunk=t,
                                         truncate=t, use_pallas=True))
    got = TD.edt_squared(torch.from_numpy(seed), truncate=t).numpy()
    np.testing.assert_array_equal(got, want)


def test_edt_squared_untruncated_matches_jax(rng):
    seed = rng.rand(3, 40, 50) < 0.01
    want = np.asarray(JD.edt_squared(jnp.asarray(seed)))
    got = TD.edt_squared(torch.from_numpy(seed)).numpy()
    np.testing.assert_array_equal(got, want)


def test_trimap_transform_matches_jax(rng):
    tri2 = np.zeros((1, 64, 64, 2), np.float32)
    tri2[0, :20, :, 0] = 1.0
    tri2[0, 40:, 10:50, 1] = 1.0
    tri2[0, rng.rand(64, 64) < 0.01, 1] = 1.0
    want = np.asarray(JD.trimap_transform(jnp.asarray(tri2)))
    got = TD.trimap_transform(torch.from_numpy(tri2)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 6)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("model,dilate", [
    ("vmn_fba", None), ("vmn_dim", None), ("vmn_gca", None),
    ("vmn_fba", 5), ("vmn_gca", 3)])
def test_preprocess_eval_matches_jax(rng, model, dilate):
    img = rng.randint(0, 256, (2, 48, 40, 3)).astype(np.float32)
    tri = np.zeros((2, 48, 40, 1), np.float32)
    tri[:, 10:40, 5:35] = 128.0
    tri[:, 20:30, 15:25] = 255.0
    want = JFM.preprocess_eval(jnp.asarray(img), jnp.asarray(tri),
                               JFM.TaskConfig(model=model,
                                              dilate_radius=dilate))
    got = TFM.preprocess_eval(torch.from_numpy(img), torch.from_numpy(tri),
                              TFM.TaskConfig(model=model,
                                             dilate_radius=dilate))
    for key in ("scaled_imgs", "imgs", "trimasks", "tris"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "tcvom_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "tcvom_tpu")
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path}: imports {mod}"
