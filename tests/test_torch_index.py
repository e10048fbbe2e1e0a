"""The port's IndexNet backbone against the JAX package's, on the CPU:
``pixel_shuffle``, the encoder's 13 features, the single-frame ``index`` and
the ``vmn_index`` models (FAM at C = 32), their losses, the f32 stream, and
the weights carried both ways, BatchNorm statistics included.

At published widths and 64x64, with the weights prepared as in
``test_torch_dim.py`` (calibrated, then random BatchNorm statistics)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.infer.predict import StreamingPredictor as JSP
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models import index as JIx
from tcvom_tpu.models import registry as JR
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.ops import image as JI
from tcvom_tpu.utils.checkpoint import load_weights as jax_load_weights
from tcvom_tpu_torch.infer.predict import StreamingPredictor as TSP
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import calibrate_random_weights
from tcvom_tpu_torch.ops import image as TI
from tcvom_tpu_torch.utils.checkpoint import save_weights
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict
from test_torch_dim import (TOL, WINDOW, H, W, _clip, _frames, _inputs,
                            _lively, _n, _t, carried, hold_test_folder,
                            load_port, randomize_batchnorms)


@pytest.fixture(scope="module")
def models():
    """{"vmn_index": (JAX module, variables, port), "index": (...)}, as
    test_torch_dim.py's fixture builds DIM's."""
    jmod = JR.build_model("vmn_index", agg_window=WINDOW)
    key = jax.random.PRNGKey(1)
    init = jax.jit(lambda: jmod.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 3, H, W, 4)),
        jnp.ones((1, 3, H, W, 1)), train=False))()
    port = load_port("vmn_index", init)
    imgs, tris = (torch.from_numpy(a) for a in _frames(21))
    cfg = TFM.TaskConfig(model="vmn_index", agg_window=WINDOW)
    calibrate_random_weights(port, lambda: TFM.forward_eval(port, imgs, tris,
                                                            cfg))
    randomize_batchnorms(port, 22)
    variables = carried("vmn_index", init, port)
    single_vars = {coll: {k: v for k, v in tree.items() if k != "fam"}
                   for coll, tree in variables.items()}
    return {"vmn_index": (jmod, variables, port),
            "index": (JR.build_model("index"), single_vars,
                      load_port("index", single_vars))}


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax(rng, r):
    x = rng.randn(2, 3, 5, 4 * r * r).astype(np.float32)      # NHWC
    want = JI.pixel_shuffle(jnp.asarray(x), r)
    got = TI.pixel_shuffle(_t(x), r)
    assert got.shape == (2, 4, 3 * r, 5 * r)
    np.testing.assert_array_equal(_n(got), np.asarray(want))


def test_encoder_matches_jax(models):
    """The 13 features: the index-weighted skips, the decoder's index maps
    and ASPP's output."""
    _, variables, port = models["vmn_index"]
    x, _ = _inputs(1)
    enc = {"params": variables["params"]["encoder"],
           "batch_stats": variables["batch_stats"]["encoder"]}
    want = jax.jit(lambda v, a: JIx.IndexMattingEncoder().apply(v, a))(
        enc, x[:, 0])
    with torch.no_grad():
        got = port.encoder(_t(x[:, 0]))
    assert sorted(got) == sorted(want) and len(got) == 13
    for k in want:
        np.testing.assert_allclose(_n(got[k]), np.asarray(want[k]), **TOL,
                                   err_msg=k)


def test_single_frame_alpha_matches_jax(models):
    jmod, variables, port = models["index"]
    x, _ = _inputs(2)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(variables, x[:, 1])
    with torch.no_grad():
        got = port(_t(x[:, 1]))
    assert got.shape == (1, 1, H, W)
    _lively(want)
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


def test_vmn_full_clip_matches_jax(models):
    """S = 3, window 3, FAM at C = 32: preds, attb, attf, the small mask."""
    jmod, variables, port = models["vmn_index"]
    x, masks = _inputs(3)
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
    jmod, variables, port = models["vmn_index"]
    x, masks = _inputs(4)
    enc_fn = jax.jit(lambda v, a: jmod.apply(
        v, a, method=JVMN.encode_extract_qkv))
    encs_j = [enc_fn(variables, x[:, i]) for i in range(3)]
    with torch.no_grad():
        encs_t = [port.encode_extract_qkv(_t(x[:, i])) for i in range(3)]
    for (_, qj), (_, qt) in zip(encs_j, encs_t):
        for key in ("q", "k", "v"):
            assert qt[key].shape == (1, 32, H // 8, W // 8)
            np.testing.assert_allclose(_n(qt[key]), np.asarray(qj[key]),
                                       **TOL, err_msg=key)
    want = jax.jit(lambda v, e, q, kb, kf, m: jmod.apply(
        v, e, q, kb, kf, m, need_logits=False,
        method=JVMN.decode_window_qkv))(
        variables, encs_j[1][0], encs_j[1][1], encs_j[0][1]["k"],
        encs_j[2][1]["k"], masks[:, 1])[0]
    with torch.no_grad():
        got = port.decode_window_qkv(
            type(port.decoder).prune_enc_head(encs_t[1][0]), encs_t[1][1],
            encs_t[0][1]["k"], encs_t[2][1]["k"], _t(masks[:, 1]))[0]
    _lively(want)
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,forward,s", [("index", "single", 3),
                                           ("vmn_index", "single", 3),
                                           ("vmn_index", "vmd", 5)])
def test_losses_match_jax(models, name, forward, s):
    jmod, variables, port = models[name]
    batch = _clip(5, s)
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


@pytest.mark.parametrize("name", ["index", "vmn_index"])
def test_forward_eval_matches_jax(models, name):
    jmod, variables, port = models[name]
    imgs, tris = _frames(6)
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
    jmod, variables, port = models["vmn_index"]
    imgs, tris = (a[0, :, None].astype(np.uint8) for a in _frames(7, 4))
    kw = dict(model="vmn_index", agg_window=WINDOW)
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


@pytest.mark.parametrize("name", ["index", "vmn_index"])
def test_predict_test_folder_matches_jax(models, tmp_path, name):
    """As test_torch_dim.py's: the single-frame loop and the stream."""
    hold_test_folder(*models[name], name, tmp_path)


@pytest.mark.parametrize("name", ["index", "vmn_index"])
def test_weights_carry_both_ways(models, name, tmp_path):
    """As test_torch_dim.py's: every tensor, both converters, a .pth."""
    jmod, variables, port = models[name]
    sd = jax_to_torch_state_dict(name, jax.tree.map(np.asarray, variables))
    own = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v), k
    stats = [k for k in own if k.endswith("running_var")]
    assert len(stats) == len(jax.tree.leaves(variables["batch_stats"])) // 2
    assert not any(torch.allclose(own[k], torch.ones_like(own[k]))
                   for k in stats)
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
