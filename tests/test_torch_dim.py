"""The port's DIM backbone against the JAX package's, on the CPU: the argmax
pool and unpool, the single-frame ``dim`` and the ``vmn_dim`` models, their
losses, the f32 stream, and the weights carried both ways, BatchNorm
statistics included.

DIM has no width knob, so the models are at published widths (``conv6``
alone is 102.8 M parameters), at 64x64; a module fixture builds them once.
Their random weights are calibrated (``calibrate_random_weights``), so that
the mattes are not all 0, and the BatchNorms then get random statistics
and affines away from 0 and 1, so that a swapped or dropped statistic
shows."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.infer import predict as JP
from tcvom_tpu.infer.predict import StreamingPredictor as JSP
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models import registry as JR
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.ops import image as JI
from tcvom_tpu.utils.checkpoint import load_weights as jax_load_weights
from tcvom_tpu.utils.convert import convert_state_dict, merge_variables
from tcvom_tpu_torch.infer import predict as TP
from tcvom_tpu_torch.infer.predict import StreamingPredictor as TSP
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import (build_model,
                                             calibrate_random_weights)
from tcvom_tpu_torch.ops import image as TI
from tcvom_tpu_torch.utils.checkpoint import save_weights
from tcvom_tpu_torch.tools.make_fake_dataset import make_wild_folder
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict
from tcvom_tpu_torch.utils.imageio import IMREAD_GRAYSCALE, imread

H = W = 64
WINDOW = 3
TOL = dict(atol=1e-4, rtol=0)


def _t(a):
    """NHWC numpy -> NCHW torch (a copy)."""
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


def _n(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def _frames(seed: int, s: int = 3):
    """imgs ``[1, S, H, W, 3]``, tris ``[1, S, H, W, 1]`` (0, 128, 255),
    f32 0..255; the trimap moves per frame."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (1, s, H, W, 3)).astype(np.float32)
    tris = np.zeros((1, s, H, W, 1), np.float32)
    for i in range(s):
        tris[0, i, 12 + i:52 + i, 8:56] = 128
        tris[0, i, 26 + i:38 + i, 22:42] = 255
    return imgs, tris


def randomize_batchnorms(model, seed: int):
    """Random running statistics and affines about the calibrated ones,
    away from 0 and 1."""
    rng = np.random.RandomState(seed)

    def draw(fn, *args):
        return torch.from_numpy(fn(*args).astype(np.float32))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.add_(draw(rng.normal, 0.3, 0.2, c))
                m.running_var.mul_(draw(rng.uniform, 0.5, 2.0, c))
                m.weight.mul_(draw(rng.uniform, 0.7, 1.4, c))
                m.bias.add_(draw(rng.normal, 0.1, 0.1, c))


def carried(name, init, port):
    """The JAX variables of ``port``'s weights, through the JAX package's
    own converter: every leaf of ``init`` replaced, none left over."""
    loaded, unmatched = convert_state_dict(name, port.state_dict())
    merged, missing, unexpected = merge_variables(init, loaded)
    assert (unmatched, missing, unexpected) == ([], [], [])
    return jax.tree.map(jnp.asarray, merged)


def load_port(name, variables):
    """A port model with ``variables`` through ``jax_to_torch_state_dict``;
    only ``num_batches_tracked`` is the module's own."""
    port = build_model(name, agg_window=WINDOW, device="cpu")
    res = port.load_state_dict(jax_to_torch_state_dict(
        name, jax.tree.map(np.asarray, variables)), strict=False)
    assert res.unexpected_keys == []
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    return port


@pytest.fixture(scope="module")
def models():
    """{"vmn_dim": (JAX module, variables, port), "dim": (...)}: the JAX
    VMN initialised once, its weights carried to the port, calibrated
    there on a clip and given random BatchNorm statistics, and carried
    back; the single-frame model takes the same weights without the FAM."""
    jmod = JR.build_model("vmn_dim", agg_window=WINDOW)
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda: jmod.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 3, H, W, 4)),
        jnp.ones((1, 3, H, W, 1)), train=False))()
    port = load_port("vmn_dim", init)
    imgs, tris = (torch.from_numpy(a) for a in _frames(11))
    cfg = TFM.TaskConfig(model="vmn_dim", agg_window=WINDOW)
    calibrate_random_weights(port, lambda: TFM.forward_eval(port, imgs, tris,
                                                            cfg))
    randomize_batchnorms(port, 12)
    variables = carried("vmn_dim", init, port)
    single_vars = {coll: {k: v for k, v in tree.items() if k != "fam"}
                   for coll, tree in variables.items()}
    return {"vmn_dim": (jmod, variables, port),
            "dim": (JR.build_model("dim"), single_vars,
                    load_port("dim", single_vars))}


# ---------------------------------------------------------------------------
# the argmax pool and its unpool
# ---------------------------------------------------------------------------

def _pool_input(rng, kind: str):
    """NHWC ``[2, 6, 8, 5]``, f32, drawn window by window: random, every
    window one value (and sample 0 all zeros, as ReLU leaves it), or each
    window's max twice, at each pair of slots in turn."""
    win = rng.randn(2, 3, 4, 5, 4)              # [N, h, w, C, slot]
    if kind == "all_equal":
        win[:] = win[..., :1]
        win[0] = 0.0
    elif kind == "two_way":
        flat = win.reshape(-1, 4)
        pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        for i, row in enumerate(flat):
            row[list(pairs[i % 6])] = row.max() + 1.0
    x = win.reshape(2, 3, 4, 5, 2, 2).transpose(0, 1, 4, 2, 5, 3)
    return x.reshape(2, 6, 8, 5).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "all_equal", "two_way"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_unpool_match_jax(rng, kind, dtype):
    """``max_pool_argmax_2x2`` and ``max_unpool_2x2``: the pooled values,
    the in-window index (first max on ties) and the unpooled map, exactly,
    with exact ties in every window or at every pair of slots."""
    xj = jnp.asarray(_pool_input(rng, kind), getattr(jnp, dtype))
    pooled_j, idx_j = JI.max_pool_argmax_2x2(xj)
    un_j = JI.max_unpool_2x2(pooled_j, idx_j)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    pooled_t, idx_t = TI.max_pool_argmax_2x2(xt)
    un_t = TI.max_unpool_2x2(pooled_t, idx_t)
    assert idx_t.dtype == torch.uint8 and pooled_t.dtype == xt.dtype
    np.testing.assert_array_equal(_n(idx_t).astype(np.int32),
                                  np.asarray(idx_j))
    for got, want in ((pooled_t, pooled_j), (un_t, un_j)):
        np.testing.assert_array_equal(_n(got.float()),
                                      np.asarray(want.astype(jnp.float32)))
    if kind == "two_way":
        assert set(np.unique(np.asarray(idx_j))) == {0, 1, 2}


def test_unpool_keeps_channels_last_inputs(rng):
    """The stream's tensors are channels-last views of NHWC data."""
    x = rng.randn(1, 4, 6, 3).astype(np.float32)
    want = TI.max_unpool_2x2(*TI.max_pool_argmax_2x2(_t(x)))
    got = TI.max_unpool_2x2(*TI.max_pool_argmax_2x2(
        torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _inputs(seed: int, s: int = 3):
    """The network's input ``[1, S, H, W, 4]`` and unknown masks, from
    preprocess_eval of noise frames."""
    imgs, tris = _frames(seed, s)
    pre = TFM.preprocess_eval(torch.from_numpy(imgs), torch.from_numpy(tris),
                              TFM.TaskConfig(model="dim"))
    x = torch.cat([pre["imgs"], pre["tris"]], dim=-1).numpy()
    return x, pre["trimasks"].numpy()


def _lively(alpha):
    """The matte is not saturated: the comparison means something."""
    a = np.asarray(alpha)
    assert ((a > 0.01) & (a < 0.99)).mean() > 0.1


def test_single_frame_alpha_matches_jax(models):
    jmod, variables, port = models["dim"]
    x, _ = _inputs(1)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(variables, x[:, 1])
    with torch.no_grad():
        got = port(_t(x[:, 1]))
    assert got.shape == (1, 1, H, W)
    _lively(want)
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


def test_vmn_full_clip_matches_jax(models):
    """The whole clip (S = 3, window 3): preds with zero end frames, the
    FAM logits attb and attf, the small mask."""
    jmod, variables, port = models["vmn_dim"]
    x, masks = _inputs(2)
    want = jax.jit(lambda v, a, m: jmod.apply(v, a, m))(variables, x, masks)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                   torch.from_numpy(masks).permute(0, 1, 4, 2, 3))
    _lively(want[0][:, 1])
    np.testing.assert_allclose(got[0].permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:3], want[1:3]):
        assert g.shape == (1, 1, H // 8, W // 8, WINDOW ** 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[3].permute(0, 1, 3, 4, 2).numpy(),
                                  np.asarray(want[3]))


def test_vmn_encode_decode_qkv_matches_jax(models):
    """The stream's halves: each frame's pool indices and q, k, v, then the
    center's matte from its neighbours' keys, through the pruned cache."""
    jmod, variables, port = models["vmn_dim"]
    x, masks = _inputs(3)
    enc_fn = jax.jit(lambda v, a: jmod.apply(
        v, a, method=JVMN.encode_extract_qkv))
    encs_j = [enc_fn(variables, x[:, i]) for i in range(3)]
    with torch.no_grad():
        encs_t = [port.encode_extract_qkv(_t(x[:, i])) for i in range(3)]
    for (ej, qj), (et, qt) in zip(encs_j, encs_t):
        for ij, it in zip(ej["indices"], et["indices"]):
            np.testing.assert_array_equal(_n(it).astype(np.int32),
                                          np.asarray(ij))
        for key in ("q", "k", "v"):
            np.testing.assert_allclose(_n(qt[key]), np.asarray(qj[key]),
                                       **TOL, err_msg=key)
    want = jax.jit(lambda v, e, q, kb, kf, m: jmod.apply(
        v, e, q, kb, kf, m, need_logits=False,
        method=JVMN.decode_window_qkv))(
        variables, encs_j[1][0], encs_j[1][1], encs_j[0][1]["k"],
        encs_j[2][1]["k"], masks[:, 1])[0]
    with torch.no_grad():
        got, attb, attf, _ = port.decode_window_qkv(
            type(port.decoder).prune_enc_head(encs_t[1][0]), encs_t[1][1],
            encs_t[0][1]["k"], encs_t[2][1]["k"], _t(masks[:, 1]))
    assert attb is None and attf is None
    _lively(want)
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


def _clip(seed: int, s: int):
    """a, fg, bg ``[1, S, H, W, .]`` f32 0..255: a soft-edged disc moving
    per frame over noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    a = np.stack([np.clip((18 - np.hypot(yy - 30 - 2 * t, xx - 32)) / 6.0,
                          0, 1) * 255 for t in range(s)])[None, ..., None]
    fg, bg = (rng.randint(0, 256, (1, s, H, W, 3)).astype(np.float32)
              for _ in range(2))
    return {"a": a.astype(np.float32), "fg": fg, "bg": bg}


@pytest.mark.parametrize("name,forward,s", [("dim", "single", 3),
                                           ("vmn_dim", "single", 3),
                                           ("vmn_dim", "vmd", 5)])
def test_losses_match_jax(models, name, forward, s):
    """forward_single (the single-frame model; the VMN's TAM pretrain) and
    forward_vmd (S = 5, so L_dt is live) at a fixed trimap width."""
    jmod, variables, port = models[name]
    batch = _clip(4, s)
    kw = dict(model=name, agg_window=WINDOW, dilate_radius=3)
    jfwd, tfwd = ((JFM.forward_single, TFM.forward_single)
                  if forward == "single" else
                  (JFM.forward_vmd, TFM.forward_vmd))
    jcfg = JFM.TaskConfig(**kw)
    want, jaux, _ = jax.jit(lambda v, b: jfwd(
        jmod, v, jax.random.PRNGKey(0), b, jcfg, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, aux = tfwd(port, {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                        TFM.TaskConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(aux["alphas"].numpy(),
                               np.asarray(jaux["alphas"]), **TOL)


@pytest.mark.parametrize("name", ["dim", "vmn_dim"])
def test_forward_eval_matches_jax(models, name):
    jmod, variables, port = models[name]
    imgs, tris = _frames(5)
    kw = dict(model=name, agg_window=WINDOW)
    jcfg = JFM.TaskConfig(**kw)
    want = jax.jit(lambda v, i, t: JFM.forward_eval(jmod, v, i, t, jcfg))(
        variables, imgs, tris)
    with torch.inference_mode():
        got = TFM.forward_eval(port, torch.from_numpy(imgs),
                               torch.from_numpy(tris), TFM.TaskConfig(**kw))
    assert got.shape == (1, 3, H, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_streaming_quantized_matches_jax(models):
    """The f32 StreamingPredictor over 4 frames: uint8 mattes within one
    level on >= 99 % of pixels, known pixels pasted."""
    jmod, variables, port = models["vmn_dim"]
    imgs, tris = (a[0, :, None].astype(np.uint8) for a in _frames(6, 4))
    kw = dict(model="vmn_dim", agg_window=WINDOW)
    outs = []
    for sp in (JSP(jmod, variables, JFM.TaskConfig(**kw), fgbg=False,
                   quantize=True),
               TSP(port, TFM.TaskConfig(**kw), fgbg=False, quantize=True,
                   device="cpu")):
        state, res = None, []
        for img, tri in zip(imgs, tris):
            state, out = sp.step(state, img, tri)
            if out is not None:
                res.append(np.asarray(out))
        outs.append(np.stack(res + [np.asarray(sp.flush(state))]))
    want, got = outs
    assert got.shape == (4, 1, H, W) and got.dtype == np.uint8
    unknown = tris[..., 0] == 128
    assert ((got[unknown] > 0) & (got[unknown] < 255)).mean() > 0.1
    np.testing.assert_array_equal(got[~unknown], tris[..., 0][~unknown])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def hold_test_folder(jmod, variables, port, name, tmp_path):
    """pred_test's pipeline, JAX's and the port's, on a wild folder of 3
    frames of 60x90 (padded to 64x96, cropped back): the single-frame
    loop or the stream; uint8 mattes within one level on >= 99 % of
    pixels, and not saturated."""
    src = str(tmp_path / "wild")
    make_wild_folder(src, frames=3, hw=(60, 90))
    kw = dict(model=name, agg_window=WINDOW)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    JP.predict_test_folder(jmod, variables, JFM.TaskConfig(**kw), src, jout)
    stats = TP.predict_test_folder(port, TFM.TaskConfig(**kw), src, tout,
                                   device="cpu")
    assert stats["frames"] == 3
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 3
    for fn in names:
        want = imread(os.path.join(jout, fn), IMREAD_GRAYSCALE).astype(int)
        got = imread(os.path.join(tout, fn), IMREAD_GRAYSCALE).astype(int)
        tri = imread(os.path.join(src, fn.replace("alpha", "trimap")),
                     IMREAD_GRAYSCALE)
        assert got.shape == (60, 90)
        unknown = got[tri == 128]
        assert ((unknown > 0) & (unknown < 255)).mean() > 0.1
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("name", ["dim", "vmn_dim"])
def test_predict_test_folder_matches_jax(models, tmp_path, name):
    hold_test_folder(*models[name], name, tmp_path)


@pytest.mark.parametrize("name", ["dim", "vmn_dim"])
def test_weights_carry_both_ways(models, name, tmp_path):
    """jax_to_torch_state_dict gives every tensor of the port's state_dict
    (the BatchNorm running statistics included, ``num_batches_tracked``
    aside), the JAX converter reads the port's state_dict back to the same
    variables, and the JAX package loads a .pth the port wrote with no
    missing or unexpected key."""
    jmod, variables, port = models[name]
    sd = jax_to_torch_state_dict(name, jax.tree.map(np.asarray, variables))
    own = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v), k
    stats = [k for k in own if k.endswith("running_var")]
    assert len(stats) == 13 and not any(
        torch.allclose(own[k], torch.ones_like(own[k])) for k in stats)
    path = str(tmp_path / f"{name}.pth")
    save_weights(port, path)
    back, missing, unexpected = jax_load_weights(name, variables, path)
    assert (missing, unexpected) == ([], [])
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for p, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[p]), np.asarray(leaf),
                                      err_msg=str(p))
