"""``pred_vmn --space``'s bands (``tcvom_tpu_torch/parallel/space.py``) on
the CPU:

- the band table, in process;
- every band op on two gloo ranks (run as ``python tests/test_torch_space.py
  ops <folder>``, one process a rank, as ``test_torch_dist.py``'s launchers
  start them), in f64, at two frame heights (64: two bands of 32 rows; 96:
  64 and 32): the convolutions (kernel 1, 3, 5, 7, stride 1 and 2,
  dilation 1, 2, 4, at 1, 1/8 and 1/32 of the input rows, where a band is
  one row and a 7x7 conv's halo is longer than it), the 3x3/2/1 max pool,
  the 2x2 argmax pool and unpool, GroupNorm, adaptive pooling at 1, 2, 3
  and 6 bins, the x2 bilinear upsampling, the nearest downsampling and
  FAM (the plain version, window 3 and 7, a halo longer than a band among
  them); GCA's spectral-norm convs (3x3 at stride 1 and 2, 1x1) and
  transposed (4, 2, 1) convs (at 1/2, 1/8 and 1/32 of the input rows),
  its guidance head's reflection pad and stride-2 conv, the 2x2 average
  pool, the nearest x2 upsampling and the attention core (at OS 16, its
  alpha at OS 8); IndexNet's pixel shuffle and ASPP (its pool summed over
  the bands). Each op's result, gathered whole, against the op on the
  whole tensor: within 1e-12, and bit for bit where no sum is reordered
  (every op but GroupNorm, adaptive pooling, the ASPP and the attention
  core);
- ``vmn_fba`` (``LAYERS`` (1, 1, 1, 1)), ``vmn_dim``, ``vmn_index`` and
  ``vmn_gca`` eval steps under ``--space 2`` (two gloo ranks, 64x64,
  window 3, B = 2, S = 3, the trimap dilated by 3) against the port in
  one process (f64 within 1e-10; f32) and against the JAX package's
  ``make_vmd_eval_step`` from the same weights through the JAX package's
  converter (``JAX_CHECKS``): FBA, DIM and IndexNet in f32 on a 2 data x
  2 space mesh (``pad_shard_batch(space_axis=2)``, as
  tests/test_sharding.py runs it), GCA in f64 on one device."""
import contextlib
import json
import os
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models import gca as TG
from tcvom_tpu_torch.models import index as TX
from tcvom_tpu_torch.models import layers as TL
from tcvom_tpu_torch.models.registry import (build_model,
                                             converge_spectral_norms)
from tcvom_tpu_torch.ops import fam as TF
from tcvom_tpu_torch.ops import image as TI
from tcvom_tpu_torch.ops.gca_attention import guided_attention_core

HEIGHTS = (64, 96)
W = 12
# (kind, kernel, stride, dilation, rows per row)
CONVS = ([("conv", k, 1, d, f) for k, d in ((1, 1), (3, 1), (5, 1), (7, 1),
                                             (3, 2), (3, 4), (5, 2), (7, 4))
          for f in (1, 8, 32)]
         + [("conv", k, 2, 1, f) for k in (1, 3, 7) for f in (1, 8)]
         + [("wsconv", 7, 2, 1, 1)])


def _conv(kind, k, s, d, rng):
    cls = TL.WSConv2d if kind == "wsconv" else TL.Conv2d
    conv = cls(3, 4, k, stride=s, padding=d * (k - 1) // 2, dilation=d)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape)))
    return conv.double()


# GCA's spectral-norm convs: (kernel, stride, padding, transpose, rows
# per row of the input)
SN_CONVS = ([(3, 1, 1, False, f) for f in (1, 8, 32)]
            + [(3, 2, 1, False, f) for f in (1, 8)] + [(1, 1, 0, False, 8)]
            + [(4, 2, 1, True, f) for f in (2, 8, 32)])


def _randomized(module: torch.nn.Module, rng) -> torch.nn.Module:
    """``module`` in f64 with every parameter drawn at random, its
    spectral-norm vectors converged and its BatchNorms' statistics drawn
    away from 0 and 1; in eval mode."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape)))
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.randn(m.num_features)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, m.num_features)))
    converge_spectral_norms(module)
    return module.double().eval()


def _guidance(rng):
    """A guidance-head stage of GCA: reflection pad 1, SN 3x3 conv stride
    2 without padding, ReLU, BatchNorm."""
    head = _randomized(torch.nn.Sequential(
        TG._ReflectionPad1(), TL.SNConv2d(3, 4, 3, 2, 0), torch.nn.ReLU(),
        TL.BatchNorm(4)), rng)
    return lambda x: TG.guidance(head, x)


def _attention_core(x):
    """GCA's attention core as its module calls it: guidance (channels
    0-3) and the unknown map (channel 7 > 0) resized to half of alpha's
    (channels 4-6) resolution."""
    half = (x.shape[-2] // 2, x.shape[-1] // 2)
    return guided_attention_core(TI.resize_nearest(x[:, :4], half), x[:, 4:7],
                                 TI.resize_nearest((x[:, 7:] > 0).double(),
                                                   half))


def _group_norm(rng):
    gn = TL.GroupNorm(2, 4)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 4)))
        gn.bias.copy_(torch.from_numpy(rng.randn(4)))
    return gn.double()


def _fam(window):
    def run(x):
        q, k, mask = x[..., :8], x[..., 8:16], (x[..., 16:] > 0).double()
        out, logits = TF.fam_attention(q, k, mask, window, need_logits=True)
        return torch.cat([out, logits], -1)
    return run


def _pool_unpool(x):
    """The 2x2 argmax pool's values unpooled, beside its indices at the
    input's resolution."""
    pooled, idx = TI.max_pool_argmax_2x2(x)
    up = idx.to(x.dtype).repeat_interleave(2, -2).repeat_interleave(2, -1)
    return torch.cat([TI.max_unpool_2x2(pooled, idx), up], 1)


def band_ops():
    """{name: (rows per row of the input, channels, the op on an input
    ``[2, C, h, W]`` (FAM: ``[2, h, W, C]``), the input's rows axis,
    whether the op's output is whole, whether it reorders a sum)}. The
    ops' parameters are drawn from a seed of their own, alike in every
    process."""
    ops = {}
    for i, (kind, k, s, d, f) in enumerate(CONVS):
        ops[f"{kind}{k}_s{s}_d{d}_at{f}"] = (
            f, 3, _conv(kind, k, s, d, np.random.RandomState(i)), -2, False,
            False)
    for f in (1, 8, 32):
        ops[f"group_norm_at{f}"] = (
            f, 4, _group_norm(np.random.RandomState(100 + f)), -2, False,
            True)
    for f in (1, 8):
        ops[f"max_pool_3x3_s2_at{f}"] = (
            f, 3, lambda x: TI.max_pool(x, 3, 2, 1), -2, False, False)
    for f in (1, 16):
        ops[f"argmax_pool_unpool_at{f}"] = (f, 3, _pool_unpool, -2, False,
                                            False)
    for s in (1, 2, 3, 6):
        ops[f"adaptive_avg_pool_{s}_at8"] = (
            8, 3, lambda x, s=s: TI.adaptive_avg_pool(x, s), -2, True, True)
    for f in (8, 32):
        ops[f"bilinear_x2_at{f}"] = (
            f, 3, lambda x: TI.resize_bilinear(
                x, (2 * x.shape[-2], 2 * x.shape[-1])), -2, False, False)
    ops["nearest_1_to_8"] = (1, 1, lambda x: TI.resize_nearest(
        x, (x.shape[-2] // 8, x.shape[-1] // 8)), -2, False, False)
    for f, window in ((8, 3), (8, 7), (32, 7)):
        ops[f"fam_window{window}_at{f}"] = (f, 17, _fam(window), 1, False,
                                            False)
    for i, (k, st, pad, transpose, f) in enumerate(SN_CONVS):
        name = f"snconv{'_transpose' * transpose}{k}_s{st}_at{f}"
        ops[name] = (f, 3, _randomized(TL.SNConv2d(
            3, 4, k, st, pad, transpose), np.random.RandomState(200 + i)),
            -2, False, False)
    for f in (1, 4, 16):
        ops[f"guidance_pad_conv_at{f}"] = (
            f, 3, _guidance(np.random.RandomState(300 + f)), -2, False,
            False)
    for f in (1, 16):
        ops[f"avg_pool_2x2_at{f}"] = (f, 3, TI.avg_pool_2x2, -2, False,
                                      False)
    for f in (8, 32):
        ops[f"upsample_nearest_x2_at{f}"] = (f, 3, TG._Upsample2(), -2,
                                             False, False)
    ops["pixel_shuffle_2_at8"] = (8, 4, lambda x: TI.pixel_shuffle(x, 2), -2,
                                  False, False)
    for f in (8, 32):
        ops[f"aspp_at{f}"] = (f, 3, _randomized(
            TX.ASPP(3, 4), np.random.RandomState(400 + f)), -2, False, True)
    ops["attention_core_at8"] = (8, 8, _attention_core, -2, False, True)
    return ops


def _input(name: str, height: int, f: int, c: int, axis: int):
    rng = np.random.RandomState(sum(map(ord, name)) + height)
    shape = (2, c, height // f, W) if axis == -2 else (2, height // f, W, c)
    x = rng.randn(*shape)
    if name.startswith("argmax"):
        x = np.round(x)          # ties, which take the first max
    return torch.from_numpy(x)


def _ops_worker(folder: str) -> None:
    """This rank's band of each op at each height, gathered, against the
    op on the whole input: ``rank_<r>.json`` {"<height>/<name>":
    [max abs error, bit-equal]}."""
    torch.set_num_threads(1)
    parallel.init_from_env("cpu", init_method=f"file://{folder}/store")
    group, ranks = parallel.space_group(2)
    res = {}
    with torch.inference_mode():
        for height in HEIGHTS:
            bands = parallel.Bands(height, group, ranks)
            for name, (f, c, op, axis, whole, _) in band_ops().items():
                x = _input(name, height, f, c, axis)
                want = op(x)
                with parallel.banded(bands):
                    got = op(bands.crop(x, axis))
                if not whole:
                    got = bands.gather_bands(got, axis)
                assert got.shape == want.shape, (name, got.shape, want.shape)
                res[f"{height}/{name}"] = [float((got - want).abs().max()),
                                           bool(torch.equal(got, want))]
            res[f"{height}/counts"] = bands.counts
    with open(os.path.join(folder, f"rank_{parallel.rank()}.json"), "w") as f:
        json.dump(res, f)


# -- the band table -----------------------------------------------------------

@pytest.mark.parametrize("height,n,blocks", [
    (1088, 2, (17, 17)), (1088, 4, (9, 9, 8, 8)), (64, 2, (1, 1)),
    (96, 2, (2, 1)), (1088, 1, (34,))])
def test_band_table(height, n, blocks):
    """Whole blocks of 32 rows, spread as evenly as they go, in order and
    covering the frame."""
    table = parallel.band_table(height, n)
    assert tuple((hi - lo) // 32 for lo, hi in table) == blocks
    assert table[0][0] == 0 and table[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(table, table[1:]))


@pytest.mark.parametrize("height,n,match", [
    (1080, 2, "not a multiple of 32"), (64, 3, "fewer than the 3 ranks"),
    (32, 2, "fewer than the 2 ranks")])
def test_band_table_refuses(height, n, match):
    with pytest.raises(ValueError, match=match):
        parallel.band_table(height, n)


def test_one_band_is_the_frame():
    """A layout of one rank (no process group): its band is the frame, and
    every exchange is the identity or a zero-filled halo."""
    bands = parallel.Bands(64)
    x = torch.arange(2 * 3 * 8 * 5, dtype=torch.float64).reshape(2, 3, 8, 5)
    assert (bands.lo, bands.hi) == (0, 64) and bands.scale(8) == 8
    assert torch.equal(bands.gather_bands(x, -2), x)
    assert torch.equal(bands.sum_over_bands(x), x)
    got = bands.rows(x, -2, 10, fill=-1.0)
    assert torch.equal(got[..., 2:10, :], x)
    assert (got[..., :2, :] == -1).all() and (got[..., 10:, :] == -1).all()
    with pytest.raises(ValueError, match="not a band"):
        bands.scale(3)


# -- every band op on two ranks -----------------------------------------------

@pytest.fixture(scope="module")
def ops_results(tmp_path_factory):
    from test_torch_dist import run_ranks

    folder = tmp_path_factory.mktemp("space_ops")
    run_ranks(os.path.abspath(__file__), ["ops", folder], timeout=300)
    return [json.loads((folder / f"rank_{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("name", sorted(band_ops()))
def test_band_op_matches_the_whole_tensor(ops_results, name, height):
    """Both ranks' gathered result within 1e-12 of the op on the whole
    tensor (f64), bit for bit where the op reorders no sum."""
    reorders = band_ops()[name][-1]
    for res in ops_results:
        err, equal = res[f"{height}/{name}"]
        assert err <= 1e-12, (name, err)
        assert equal or reorders, (name, err)


def test_band_ops_exchange(ops_results):
    """The ops took halos (one all-reduce each), sums and gathers, and both
    ranks alike: the halos of the two ranks are of one size."""
    for height in HEIGHTS:
        a, b = (res[f"{height}/counts"] for res in ops_results)
        assert set(a) == {"rows", "sum", "gather"}
        assert [c[0] for c in a.values()] == [c[0] for c in b.values()]
        assert a["rows"][1] == b["rows"][1] > 0


# -- the models under --space 2 -----------------------------------------------

MODELS = ("vmn_fba", "vmn_dim", "vmn_index", "vmn_gca")
H = 64
WINDOW = 3
LAYERS = (1, 1, 1, 1)
RADIUS = 3
# each model's comparison with JAX's step: (its dtype, atol, on JAX's 2 x
# 2 mesh). FBA at its one-process parity (tests/test_torch_streaming.py),
# DIM at JAX's own tolerance there, IndexNet at FBA's; GCA in f64 (in f32
# its attention amplifies rounding past 1e-4 in both frameworks,
# tests/test_torch_gca_model.py) and on one device: XLA:CPU partitions a
# 3x3 stride-2 conv of 4 rows over 2 space shards wrongly (17.6 off the
# unsharded conv; right at 8 rows), which GCA's OS-32 block is at 64x64
# (test_xla_cpu_mispartitions_a_four_row_stride2_conv)
JAX_CHECKS = {"vmn_fba": ("float32", 5e-4, True),
              "vmn_dim": ("float32", 1e-4, True),
              "vmn_index": ("float32", 5e-4, True),
              "vmn_gca": ("float64", 1e-4, False)}


def test_xla_cpu_mispartitions_a_four_row_stride2_conv():
    """Why GCA's comparison with JAX runs on one device (``JAX_CHECKS``).
    On JAX's 2 data x 2 space mesh, XLA:CPU computes a 3x3 stride-2
    padding-1 conv of 4 rows wrongly when its kernel is computed in the
    same jit, as GCA's spectral norm divides it by sigma
    (``tcvom_tpu/models/layers.py::SNConv``); the same conv with the
    kernel passed in, or of 8 rows, is right. When this fails, XLA
    partitions the conv right and GCA can join the mesh comparison."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from tcvom_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:4], space=2)
    rng = np.random.RandomState(0)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (2, 2), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def errs(rows, fn):
        x = rng.randn(2, rows, rows, 4).astype(np.float32)
        w = rng.randn(3, 3, 4, 8).astype(np.float32) / 6
        want = np.asarray(jax.jit(fn)(x, w))
        got = np.asarray(jax.jit(fn)(
            jax.device_put(x, NamedSharding(mesh, PartitionSpec("data",
                                                                "space"))),
            jax.device_put(w, NamedSharding(mesh, PartitionSpec()))))
        return np.abs(got - want).max() / np.abs(want).max()

    def scaled(x, w):
        return conv(x, w / jnp.sum(w * w))

    assert errs(4, conv) < 1e-6
    assert errs(8, scaled) < 1e-6
    assert errs(4, scaled) > 0.1


def _batch() -> dict:
    """a, fg, bg ``[2, 3, 64, 64, .]`` f32 0..255: soft discs of two sizes
    moving over noise."""
    rng = np.random.RandomState(31)
    yy, xx = np.mgrid[:H, :H].astype(np.float32)
    a = np.stack([np.stack([np.clip((r - np.hypot(yy - 30 - 2 * t, xx - 32))
                                    / 5 + 0.5, 0, 1) * 255
                            for t in range(3)]) for r in (14, 20)])
    return {"a": a[..., None].astype(np.float32),
            **{k: rng.randint(0, 256, (2, 3, H, H, 3)).astype(np.float32)
               for k in ("fg", "bg")}}


def _cfg(name: str) -> TFM.TaskConfig:
    return TFM.TaskConfig(model=name, agg_window=WINDOW, dilate_radius=RADIUS)


def _port(name: str, folder) -> torch.nn.Module:
    model = build_model(name, agg_window=WINDOW, layers=LAYERS, device="cpu")
    model.load_state_dict(torch.load(os.path.join(folder, f"{name}.pth")))
    return model


def _outputs(model, name: str, bands=None) -> dict:
    """The f32 eval step's (losses, alphas) and the f64 forward_vmd's
    (losses, alphas, comps, Fs, Bs), as numpy."""
    from tcvom_tpu_torch.infer.predict import make_vmd_eval_step

    out = {}
    losses, alphas, _ = make_vmd_eval_step(model, _cfg(name), bands)(_batch())
    out.update({f"f32/{k}": v.numpy() for k, v in losses.items()},
               **{"f32/alphas": alphas.numpy()})
    model.double()
    with torch.inference_mode():
        losses, aux = TFM.forward_vmd(
            model, {k: torch.from_numpy(v).double()
                    for k, v in _batch().items()}, _cfg(name), bands=bands)
    model.float()
    out.update({f"f64/{k}": v.numpy() for k, v in losses.items()},
               **{f"f64/{k}": aux[k].numpy()
                  for k in ("alphas", "comps", "Fs", "Bs")})
    return out


def _models_worker(folder: str) -> None:
    """Both models' outputs on this rank of a space group of two:
    ``<model>_rank_<r>.npz``, and the exchanges of one f32 step."""
    torch.set_num_threads(1)
    parallel.init_from_env("cpu", init_method=f"file://{folder}/store")
    group, ranks = parallel.space_group(2)
    for name in MODELS:
        bands = parallel.Bands(H, group, ranks)
        out = _outputs(_port(name, folder), name, bands)
        np.savez(os.path.join(folder, f"{name}_rank_{parallel.rank()}.npz"),
                 **out)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The models' weights, written for the ranks: FBA's random; DIM's
    and IndexNet's calibrated (``calibrate_random_weights``; random DIM
    weights give mattes of ~1e-5) with random BatchNorm statistics; GCA's
    spectral norms converged, its BatchNorms' affines drawn at random and
    the whole calibrated, as ``test_torch_gca_model.py`` prepares them."""
    from test_torch_dim import randomize_batchnorms
    from test_torch_gca_model import _randomize_batchnorm_affines
    from tcvom_tpu_torch.models.registry import calibrate_random_weights
    from tcvom_tpu_torch.utils.checkpoint import save_weights

    folder = tmp_path_factory.mktemp("space_models")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in MODELS:
            model = build_model(name, agg_window=WINDOW, layers=LAYERS,
                                device="cpu")
            if name == "vmn_gca":
                converge_spectral_norms(model)
                _randomize_batchnorm_affines(model, 11)
            if name != "vmn_fba":
                calibrate_random_weights(model, lambda: TFM.forward_vmd(
                    model, batch, _cfg(name)))
            if name in ("vmn_dim", "vmn_index"):
                randomize_batchnorms(model, 13)
            save_weights(model, str(folder / f"{name}.pth"))
    finally:
        torch.set_num_threads(threads)
    return folder


@contextlib.contextmanager
def _jax_in(dtype):
    """JAX in ``dtype``: for f64 under x64, with ``jnp`` patched in the
    attention core and the image ops so that their f32 casts read f64
    (``test_torch_gca_model.py::_in_f64``)."""
    import jax

    from tcvom_tpu.ops import gca_attention as JA
    from tcvom_tpu.ops import image as JI
    from test_torch_gca_model import _WideJnp

    if dtype == "float32":
        yield
        return
    wide = _WideJnp()
    with jax.enable_x64(True), mock.patch.object(JA, "jnp", wide), \
            mock.patch.object(JI, "jnp", wide):
        yield


def _jax_alphas(name: str, port) -> np.ndarray:
    """JAX's ``make_vmd_eval_step`` in the model's ``JAX_CHECKS`` dtype, on
    a 2 data x 2 space mesh with the batch's H axis sharded over ``space``
    or on one device: the centre alphas."""
    import jax
    import jax.numpy as jnp

    from tcvom_tpu.infer.predict import make_vmd_eval_step
    from tcvom_tpu.models import fba as JF
    from tcvom_tpu.models import full_model as JFM
    from tcvom_tpu.models import registry as JR
    from tcvom_tpu.models.vmn import VMN as JVMN
    from tcvom_tpu.parallel.mesh import make_mesh, pad_shard_batch, replicate
    from test_torch_dim import carried

    if name == "vmn_fba":
        jmod = JVMN(encoder=JF.FBAEncoder(layers=LAYERS),
                    decoder=JF.FBADecoderVMN(), fam_channels=256,
                    agg_window=WINDOW)
        extras = (jnp.zeros((1, 3, H, H, 3)), jnp.zeros((1, 3, H, H, 2)))
    else:
        jmod, extras = JR.build_model(name, agg_window=WINDOW), None
    cin = 3 + _cfg(name).trimap_channels
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, H, H, cin)),
        jnp.ones((1, 3, H, H, 1)), extras=extras, train=False))
    variables = carried(name, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), port)
    dtype, _, on_mesh = JAX_CHECKS[name]
    with _jax_in(dtype):
        variables = jax.tree.map(
            lambda a: jnp.asarray(np.array(a, dtype)), variables)
        batch = {k: v.astype(dtype) for k, v in _batch().items()}
        if on_mesh:
            mesh = make_mesh(jax.devices()[:4], space=2)
            batch, b = pad_shard_batch(batch, mesh, space_axis=2)
            variables = replicate(variables, mesh)
            assert b == 2
        step = make_vmd_eval_step(jmod, JFM.TaskConfig(
            model=name, agg_window=WINDOW, dilate_radius=RADIUS))
        _, alphas, _ = step(variables, batch, jax.random.PRNGKey(1))
        alphas = np.asarray(alphas)
    assert alphas.dtype == dtype
    return alphas


@pytest.fixture(scope="module")
def model_runs(weights):
    """{model: (the two ranks' outputs, one process's, JAX's centre
    alphas)}: the ranks run while this process computes the rest."""
    from test_torch_dist import run_ranks_started, wait_all

    procs = run_ranks_started(os.path.abspath(__file__), ["models", weights])
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in MODELS:
            port = _port(name, weights)
            runs[name] = [None, _outputs(port, name),
                          _jax_alphas(name, port)]
    finally:
        torch.set_num_threads(threads)
    wait_all(procs, 600)
    for name in MODELS:
        runs[name][0] = [dict(np.load(weights / f"{name}_rank_{r}.npz"))
                         for r in range(2)]
    return runs


@pytest.mark.parametrize("name", MODELS)
def test_space_step_matches_one_process_f64(model_runs, name):
    """Each rank's losses and whole alphas, composites, F and B in f64
    within 1e-10 of one process's."""
    ranks, one, _ = model_runs[name]
    keys = [k for k in one if k.startswith("f64/")]
    assert len(keys) == 9
    for got in ranks:
        for k in keys:
            np.testing.assert_allclose(got[k], one[k], rtol=0, atol=1e-10,
                                       err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_space_step_matches_one_process_f32(model_runs, name):
    """The f32 eval step of each rank against one process's: the alphas
    within 1e-4, the losses within rtol 1e-5 (GroupNorm's and the pools'
    sums reassociate in f32; FBA's alphas moved by 1.1e-5 at most)."""
    ranks, one, _ = model_runs[name]
    for got in ranks:
        for k in one:
            if k.startswith("f32/"):
                np.testing.assert_allclose(
                    got[k], one[k], rtol=1e-5,
                    atol=1e-4 if k == "f32/alphas" else 1e-7, err_msg=k)


def _hold_jax(model_runs, name: str) -> None:
    """Each rank's centre alphas within the model's ``JAX_CHECKS`` atol of
    JAX's; mattes that are not all 0 or 1."""
    ranks, _, want = model_runs[name]
    dtype, atol, _ = JAX_CHECKS[name]
    for got in ranks:
        alphas = (got["f32/alphas"] if dtype == "float32"
                  else got["f64/alphas"][:, 1])       # [B, S, H, W, 1]
        assert alphas.shape == want.shape == (2, H, H, 1)
        np.testing.assert_allclose(alphas, want, atol=atol, rtol=0)
    live = (want > 0.01) & (want < 0.99)
    assert live.mean() > 0.02, live.mean()


@pytest.mark.parametrize("name,atol", [(n, JAX_CHECKS[n][1]) for n in MODELS
                                       if JAX_CHECKS[n][2]])
def test_space_step_matches_jax_space_mesh(model_runs, name, atol):
    """The centre alphas of the f32 step under ``--space 2`` against JAX's
    step on its 2 x 2 mesh."""
    _hold_jax(model_runs, name)


def test_space_step_matches_jax_gca_f64(model_runs):
    """GCA's centre alphas under ``--space 2`` in f64 against JAX's f64
    step on one device (``JAX_CHECKS``: JAX's mesh step is wrong for GCA
    at this size)."""
    _hold_jax(model_runs, "vmn_gca")


if __name__ == "__main__":
    {"ops": _ops_worker, "models": _models_worker}[sys.argv[1]](sys.argv[2])
