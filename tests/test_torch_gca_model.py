"""The port's GCA backbone against the JAX package's, on the CPU: the guided
contextual attention module, the single-frame ``gca`` and the ``vmn_gca``
models, their losses, ``forward_eval``, the f32 stream, the wild-folder
pipeline, and the weights carried both ways, spectral-norm vectors and
BatchNorm statistics included.

GCA has no width knob, so the models are at published widths, at 64x64
(60x90 padded to 64x96 for the folder); a module fixture builds them once.
At the JAX package's initialisation the residual branches (``bn2`` scale
0) and the attention (``W`` scale 1e-3) are nearly silent and a parity
test would hold little, so the fixture gives every BatchNorm a random
scale and bias, sets each spectral-norm conv's ``u`` and ``v`` to the
leading singular vectors of its weight (random ones give sigma near 0)
and takes every running statistic from a pass over random frames
(``calibrate_random_weights``): per-channel values away from 0 and 1 that
keep the signal at unit scale. (Moving them at random after the pass, as
the DIM tests do, compounds through GCA's 72 BatchNorms: the FAM logits
reached 170, where f32 rounding alone moves them by 7e-4, port against
port in f64.)"""
import copy
import os
import unittest.mock as mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.infer import predict as JP
from tcvom_tpu.infer.predict import StreamingPredictor as JSP
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models import gca as JG
from tcvom_tpu.models import registry as JR
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.ops import gca_attention as JA
from tcvom_tpu.ops import image as JI
from tcvom_tpu.utils.checkpoint import load_weights as jax_load_weights
from tcvom_tpu.utils.convert import convert_state_dict, merge_variables
from tcvom_tpu_torch.infer import predict as TP
from tcvom_tpu_torch.infer.predict import StreamingPredictor as TSP
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import (build_model,
                                             calibrate_random_weights,
                                             converge_spectral_norms)
from tcvom_tpu_torch.tools.make_fake_dataset import make_wild_folder
from tcvom_tpu_torch.utils.checkpoint import save_weights
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


def _frames(seed: int, s: int = 3, hw=(H, W)):
    """imgs ``[1, S, H, W, 3]``, tris ``[1, S, H, W, 1]`` (0, 128, 255),
    f32 0..255; the trimap moves per frame."""
    rng = np.random.RandomState(seed)
    h, w = hw
    imgs = rng.randint(0, 256, (1, s, h, w, 3)).astype(np.float32)
    tris = np.zeros((1, s, h, w, 1), np.float32)
    for i in range(s):
        tris[0, i, 12 + i:52 + i, 8:56] = 128
        tris[0, i, 26 + i:38 + i, 22:42] = 255
    return imgs, tris


def _randomize_batchnorm_affines(model, seed: int):
    """Every BatchNorm's scale and bias drawn at random (away from 0, 1 and
    GCA's 1e-3)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0.6, 1.2, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    rng.normal(0.0, 0.1, c).astype(np.float32)))


def _zeros_like_init(jmod, *args):
    """The JAX variables' tree, zeros: the paths and shapes of an init,
    traced but not compiled."""
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, *args, train=False))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


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
    """{"vmn_gca": (JAX module, variables, port), "gca": (...)}: the port's
    VMN with the weights the module docstring describes, carried to the
    JAX package; the single-frame model takes the same weights without the
    FAM."""
    port = build_model("vmn_gca", agg_window=WINDOW, device="cpu")
    converge_spectral_norms(port)
    _randomize_batchnorm_affines(port, 11)
    imgs, tris = (torch.from_numpy(a) for a in _frames(12))
    cfg = TFM.TaskConfig(model="vmn_gca", agg_window=WINDOW)
    calibrate_random_weights(port, lambda: TFM.forward_eval(port, imgs, tris,
                                                            cfg))
    jmod = JR.build_model("vmn_gca", agg_window=WINDOW)
    variables = carried("vmn_gca", _zeros_like_init(
        jmod, jnp.zeros((1, 3, H, W, 6)), jnp.ones((1, 3, H, W, 1))), port)
    single_vars = {coll: {k: v for k, v in tree.items() if k != "fam"}
                   for coll, tree in variables.items()}
    return {"vmn_gca": (jmod, variables, port),
            "gca": (JR.build_model("gca"), single_vars,
                    load_port("gca", single_vars))}


def _inputs(seed: int, s: int = 3):
    """The network's input ``[1, S, H, W, 6]`` and unknown masks, from
    preprocess_eval of noise frames (the one-hot trimap)."""
    imgs, tris = _frames(seed, s)
    pre = TFM.preprocess_eval(torch.from_numpy(imgs), torch.from_numpy(tris),
                              TFM.TaskConfig(model="gca"))
    x = torch.cat([pre["imgs"], pre["tris"]], dim=-1).numpy()
    return x, pre["trimasks"].numpy()


def _lively(alpha):
    """The matte is not saturated and not flat: the comparison means
    something."""
    a = np.asarray(alpha)
    assert ((a > 0.01) & (a < 0.99)).mean() > 0.1 and a.std() > 0.05


def _sub(variables, *path):
    """The variables of the submodule at ``path``, every collection."""
    out = {}
    for coll, tree in variables.items():
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[coll] = tree
    return out


@pytest.mark.parametrize("where", ["encoder", "decoder"])
def test_guided_cxt_atten_matches_jax(models, rng, where):
    """The attention module alone, with the trained-looking weights of the
    encoder's or the decoder's: guidance [1, 8, 8, 128], features
    [1, 8, 8, 128] (the core at 4x4), a mixed unknown mask."""
    _, variables, port = models["vmn_gca"]
    f = rng.randn(1, 8, 8, 128).astype(np.float32)
    alpha = rng.randn(1, 8, 8, 128).astype(np.float32)
    unk = np.zeros((1, 8, 8, 1), np.float32)
    unk[:, 2:6, 1:5] = 1.0
    want = JG.GuidedCxtAtten(128, 128).apply(_sub(variables, where, "gca"),
                                             f, alpha, unk)
    with torch.no_grad():
        got = getattr(port, where).gca(_t(f), _t(alpha), _t(unk))
    assert np.abs(np.asarray(want) - alpha).max() > 0.1
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


class _WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``: patched into the
    attention core and the image ops, it widens their f32 products and
    resize weights, so that an x64 forward is f64 throughout."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _in_f64(fn, variables, *args):
    """``fn(variables, *args)`` jitted under x64, the variables and inputs
    widened to f64."""
    wide = _WideJnp()
    with jax.enable_x64(True), mock.patch.object(JA, "jnp", wide), \
            mock.patch.object(JI, "jnp", wide):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.array(a), jnp.float64),
                           variables)
        out = jax.jit(fn)(v64, *jax.tree.map(
            lambda a: np.asarray(a, np.float64), args))
        return jax.tree.map(np.asarray, out)


# The models and the VMN's two halves are held in f64 on both sides: in
# f32 the attention's softmax over 9*64-wide patches amplifies rounding,
# and the JAX package's own f32 run is 5.2e-4 off its f64 run at the last
# shortcut (the port's 1.6e-4), more than the tolerance. The f32 paths are
# held at the stream's tolerances below.

def test_single_frame_alpha_matches_jax(models):
    """The single-frame model, in f64."""
    jmod, variables, port = models["gca"]
    x, _ = _inputs(1)
    want = _in_f64(lambda v, a: jmod.apply(v, a), variables, x[:, 1])
    with torch.no_grad():
        got = copy.deepcopy(port).double()(_t(x[:, 1]).double())
    assert got.shape == (1, 1, H, W)
    _lively(want)
    np.testing.assert_allclose(_n(got), want, **TOL)


def test_vmn_full_clip_matches_jax(models):
    """The whole clip (S = 3, window 3), in f64: preds with zero end
    frames, the FAM logits attb and attf, the small mask."""
    jmod, variables, port = models["vmn_gca"]
    x, masks = _inputs(2)
    want = _in_f64(lambda v, a, m: jmod.apply(v, a, m), variables, x, masks)
    with torch.no_grad():
        got = copy.deepcopy(port).double()(
            torch.from_numpy(x).double().permute(0, 1, 4, 2, 3),
            torch.from_numpy(masks).double().permute(0, 1, 4, 2, 3))
    _lively(want[0][:, 1])
    np.testing.assert_allclose(got[0].permute(0, 1, 3, 4, 2).numpy(),
                               want[0], **TOL)
    for g, w in zip(got[1:3], want[1:3]):
        assert g.shape == (1, 1, H // 8, W // 8, WINDOW ** 2)
        assert np.abs(w).max() > 1.0
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_array_equal(got[3].permute(0, 1, 3, 4, 2).numpy(),
                                  want[3])


def test_vmn_encode_decode_qkv_matches_jax(models):
    """The stream's halves, in f64: each frame's shortcuts and q, k, v,
    then the center's matte from its neighbours' keys, through the pruned
    cache."""
    jmod, variables, port = models["vmn_gca"]
    port = copy.deepcopy(port).double()
    x, masks = _inputs(3)
    encs_j = [_in_f64(lambda v, a: jmod.apply(
        v, a, method=JVMN.encode_extract_qkv), variables, x[:, i])
        for i in range(3)]
    with torch.no_grad():
        encs_t = [port.encode_extract_qkv(_t(x[:, i]).double())
                  for i in range(3)]
    for (ej, qj), (et, qt) in zip(encs_j, encs_t):
        for sj, st in zip(ej["shortcut"], et["shortcut"]):
            np.testing.assert_allclose(_n(st), sj, **TOL)
        for key in ("q", "k", "v"):
            np.testing.assert_allclose(_n(qt[key]), qj[key], **TOL,
                                       err_msg=key)
    want = _in_f64(lambda v, e, q, kb, kf, m: jmod.apply(
        v, e, q, kb, kf, m, need_logits=False,
        method=JVMN.decode_window_qkv)[0],
        variables, encs_j[1][0], encs_j[1][1], encs_j[0][1]["k"],
        encs_j[2][1]["k"], masks[:, 1])
    with torch.no_grad():
        got, attb, attf, _ = port.decode_window_qkv(
            type(port.decoder).prune_enc_head(encs_t[1][0]), encs_t[1][1],
            encs_t[0][1]["k"], encs_t[2][1]["k"], _t(masks[:, 1]).double())
    assert attb is None and attf is None
    _lively(want)
    np.testing.assert_allclose(_n(got), want, **TOL)


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


@pytest.mark.parametrize("name,forward,s", [("gca", "single", 3),
                                           ("vmn_gca", "single", 3),
                                           ("vmn_gca", "vmd", 5)])
def test_losses_match_jax(models, name, forward, s):
    """forward_single (the single-frame model; the VMN's TAM pretrain) and
    forward_vmd (S = 5, so L_dt is live) at a fixed trimap width, in f32:
    GCA has L_alpha alone, L_comp and L_grad are 0; the alphas at the
    stream's 5e-4."""
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
    assert got["L2"].item() == 0.0 and got["L3"].item() == 0.0
    assert got["L1"].item() > 0.0
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(aux["alphas"].numpy(),
                               np.asarray(jaux["alphas"]), atol=5e-4, rtol=0)


@pytest.mark.parametrize("name", ["gca", "vmn_gca"])
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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=0)


def test_streaming_quantized_matches_jax(models):
    """The f32 StreamingPredictor over 4 frames: alpha within 5e-4 and the
    uint8 mattes within one level on >= 99 % of pixels, known pixels
    pasted."""
    jmod, variables, port = models["vmn_gca"]
    imgs, tris = (a[0, :, None].astype(np.uint8) for a in _frames(6, 4))
    kw = dict(model="vmn_gca", agg_window=WINDOW)
    outs = {}
    for quantize in (False, True):
        for side, sp in (("jax", JSP(jmod, variables, JFM.TaskConfig(**kw),
                                     fgbg=False, quantize=quantize)),
                         ("port", TSP(port, TFM.TaskConfig(**kw), fgbg=False,
                                      quantize=quantize, device="cpu"))):
            state, res = None, []
            for img, tri in zip(imgs, tris):
                state, out = sp.step(state, img, tri)
                if out is not None:
                    res.append(np.asarray(out))
            outs[side, quantize] = np.stack(
                res + [np.asarray(sp.flush(state))])
    np.testing.assert_allclose(outs["port", False], outs["jax", False],
                               atol=5e-4, rtol=0)
    want, got = outs["jax", True], outs["port", True]
    assert got.shape == (4, 1, H, W) and got.dtype == np.uint8
    unknown = tris[..., 0] == 128
    assert ((got[unknown] > 0) & (got[unknown] < 255)).mean() > 0.1
    np.testing.assert_array_equal(got[~unknown], tris[..., 0][~unknown])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("name", ["gca", "vmn_gca"])
def test_predict_test_folder_matches_jax(models, tmp_path, name):
    """pred_test's pipeline, JAX's and the port's, on a wild folder of 3
    frames of 60x90 (padded to 64x96, cropped back): the single-frame
    loop or the stream; uint8 mattes within one level on >= 99 % of
    pixels, and not saturated."""
    jmod, variables, port = models[name]
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


@pytest.mark.parametrize("name", ["gca", "vmn_gca"])
def test_weights_carry_both_ways(models, name, tmp_path):
    """jax_to_torch_state_dict gives every tensor of the port's state_dict
    (``weight_bar``, ``weight_u``, ``weight_v``, the BatchNorm running
    statistics; ``num_batches_tracked`` aside), the JAX converter reads the
    port's state_dict back to the same variables, and the JAX package loads
    a .pth the port wrote with no missing or unexpected key."""
    jmod, variables, port = models[name]
    sd = jax_to_torch_state_dict(name, jax.tree.map(np.asarray, variables))
    own = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v), k
    sn = [k for k in own if k.endswith(".module.weight_bar")]
    assert len(sn) == 70 and not any("weight_orig" in k for k in own)
    stats = [k for k in own if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 72 and not any(
        torch.allclose(own[k], torch.ones_like(own[k]))
        or torch.allclose(own[k], torch.zeros_like(own[k])) for k in stats)
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
