"""The inference pipelines against the JAX package's, on the CPU: the dilated
quantized stream, ``forward_eval``, the evaluation steps (on a clip and on
an Adobe-DIM batch), the wild-folder pipeline and checkpoint loading. Both
packages load their weights from one ``.pth`` file written by the port."""
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.infer import predict as JP
from tcvom_tpu.models import fba as JF
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.utils.checkpoint import load_weights as jax_load_weights
from tcvom_tpu_torch.infer import predict as TP
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.tools.make_fake_dataset import (make_adobe,
                                                     make_wild_folder)
from tcvom_tpu_torch.utils.checkpoint import load_weights, save_weights
from tcvom_tpu_torch.utils.imageio import (IMREAD_GRAYSCALE, IMREAD_UNCHANGED,
                                           imread)

H = W = 64
LAYERS = (1, 1, 1, 1)
WINDOW = 3
WILD_HW = (60, 90)                      # padded to 64x96 and cropped back


class _SmallFBA(JF.FBA):
    """The JAX single-frame FBA at the tests' depth."""

    def setup(self):
        self.encoder = JF.FBAEncoder(layers=LAYERS)
        self.decoder = JF.FBADecoder()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (JAX module, JAX variables, port model), the weights of both
    loaded from one .pth the port wrote (drawn with another seed than the
    model that loads them)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    extras = (jnp.zeros((1, 3, H, W, 3)), jnp.zeros((1, 3, H, W, 2)))
    jmods = {
        "vmn_fba": (JVMN(encoder=JF.FBAEncoder(layers=LAYERS),
                         decoder=JF.FBADecoderVMN(), fam_channels=256,
                         agg_window=WINDOW),
                    (jnp.zeros((1, 3, H, W, 11)), jnp.ones((1, 3, H, W, 1))),
                    {"extras": extras}),
        "fba": (_SmallFBA(), (jnp.zeros((1, H, W, 11)),),
                {"extras": tuple(e[:, 0] for e in extras)}),
    }
    out = {}
    for name, (jmod, args, kw) in jmods.items():
        path = str(tmp / f"{name}.pth")
        save_weights(build_model(name, agg_window=WINDOW, layers=LAYERS,
                                 device="cpu"), path)
        key = jax.random.PRNGKey(0)
        init = jax.jit(lambda: jmod.init({"params": key, "dropout": key},
                                         *args, train=False, **kw))()
        jvars, jmiss, junex = jax_load_weights(name, init, path)
        port = build_model(name, agg_window=WINDOW, layers=LAYERS,
                           device="cpu",
                           generator=torch.Generator().manual_seed(1))
        miss, unex = load_weights(port, path)
        assert (jmiss, junex, miss, unex) == ([], [], [], [])
        out[name] = (jmod, jvars, port, path)
    return out


@pytest.fixture(scope="module")
def wild(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wild"))
    make_wild_folder(root, frames=3, hw=WILD_HW)
    return root


def _clip(seed: int, s: int = 3):
    """a, fg, bg ``[1, S, H, W, .]`` f32 0..255: a soft-edged disc moving
    per frame over noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    a = np.stack([np.clip((18 - np.hypot(yy - 30 - 2 * t, xx - 32)) / 6.0,
                          0, 1) * 255 for t in range(s)])[None, ..., None]
    fg, bg = (rng.randint(0, 256, (1, s, H, W, 3)).astype(np.float32)
              for _ in range(2))
    return {"a": a.astype(np.float32), "fg": fg, "bg": bg}


def _frames(seed: int):
    """imgs ``[1, 3, H, W, 3]``, tris ``[1, 3, H, W, 1]`` (0, 128, 255)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (1, 3, H, W, 3)).astype(np.float32)
    tris = np.zeros((1, 3, H, W, 1), np.float32)
    for i in range(3):
        tris[0, i, 14 + i:50 + i, 10:54] = 128
        tris[0, i, 26 + i:38 + i, 24:40] = 255
    return imgs, tris


def _run(sp, frames):
    state, outs = None, []
    for img, tri in frames:
        state, out = sp.step(state, img, tri)
        if out is not None:
            outs.append(np.asarray(out))
    return outs + [np.asarray(sp.flush(state))]


def _uint8_close(want, got):
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_pth_reports_missing_and_unexpected_keys(models, tmp_path):
    _, _, port, path = models["vmn_fba"]
    sd = torch.load(path)
    sd.pop("decoder.fam.key_conv.bias")
    sd["decoder.conv_up4.4.weight"] = torch.zeros(3, 3, 1, 1)   # shape
    sd["stray.weight"] = torch.zeros(1)
    wrapped = str(tmp_path / "wrapped.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               wrapped)
    model = build_model("vmn_fba", agg_window=WINDOW, layers=LAYERS,
                        device="cpu", generator=torch.Generator().manual_seed(2))
    missing, unexpected = load_weights(model, wrapped)
    assert missing == ["decoder.fam.key_conv.bias"]
    assert unexpected == ["decoder.conv_up4.4.weight", "stray.weight"]
    own, ref = model.state_dict(), port.state_dict()
    assert torch.equal(own["encoder.conv1.weight"], ref["encoder.conv1.weight"])
    assert not torch.equal(own["decoder.conv_up4.4.weight"],
                           ref["decoder.conv_up4.4.weight"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_weights(model, str(tmp_path))


def test_quantized_stream_dilated_matches_jax(models, wild):
    """With ``dilate_radius`` the known pixels are pasted outside the
    DILATED unknown region, as the JAX package pastes them."""
    jmod, jvars, port, _ = models["vmn_fba"]
    frames = [TP.TestFolder(wild).read_frame(i)[:2] for i in range(3)]
    kw = dict(fgbg=False, quantize=True)
    jsp = JP.StreamingPredictor(jmod, jvars, JFM.TaskConfig(
        model="vmn_fba", agg_window=WINDOW, dilate_radius=3), **kw)
    tsp = TP.StreamingPredictor(port, TFM.TaskConfig(
        model="vmn_fba", agg_window=WINDOW, dilate_radius=3), device="cpu",
        **kw)
    want, got = _run(jsp, frames), _run(tsp, frames)
    assert len(want) == len(got) == 3
    for want, got in zip(want, got):
        assert got.shape == (1, 64, 96) and got.dtype == np.uint8
        _uint8_close(want, got)


@pytest.mark.parametrize("name", ["vmn_fba", "fba"])
def test_forward_eval_matches_jax(models, name):
    jmod, jvars, port, _ = models[name]
    imgs, tris = _frames(3)
    jcfg = JFM.TaskConfig(model=name, agg_window=WINDOW)
    tcfg = TFM.TaskConfig(model=name, agg_window=WINDOW)
    want = jax.jit(lambda v, i, t: JFM.forward_eval(jmod, v, i, t, jcfg))(
        jvars, imgs, tris)
    with torch.inference_mode():
        got = TFM.forward_eval(port, torch.from_numpy(imgs),
                               torch.from_numpy(tris), tcfg)
    for w, g, c in zip(want, got, (1, 3, 3)):     # alpha, F, B
        assert g.shape == (1, 3, H, W, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)


@pytest.fixture(scope="module")
def eval_steps(models):
    """name -> (JAX step, port step) at the narrow trimap width:
    make_vmd_eval_step for the VMN, make_single_eval_step for the
    single-frame model. One jitted JAX step a model serves every test of
    the module (one compile a shape)."""
    dil = TP.TRIMAP_DILATION["narrow"]
    out = {}
    for name, jmake, tmake in (
            ("vmn_fba", JP.make_vmd_eval_step, TP.make_vmd_eval_step),
            ("fba", JP.make_single_eval_step, TP.make_single_eval_step)):
        jmod, jvars, port, _ = models[name]
        kw = dict(model=name, agg_window=WINDOW, dilate_radius=dil)
        jstep = jmake(jmod, JFM.TaskConfig(**kw))
        out[name] = (functools.partial(jstep, jvars),
                     tmake(port, TFM.TaskConfig(**kw)))
    return out


def _hold_eval_step(steps, batch):
    """The port's losses (rtol 1e-4), alpha (atol 5e-4) and trimap (equal)
    against JAX's on ``batch``; returns the port's trimap."""
    jstep, tstep = steps
    jl, ja, jt = jstep({k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(1))
    tl, ta, tt = tstep(batch)
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert ta.shape == tt.shape == (1, H, W, 1)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=5e-4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    return tt


@pytest.mark.parametrize("name", ["vmn_fba", "fba"])
def test_eval_step_matches_jax(eval_steps, name):
    """make_vmd_eval_step for the VMN, make_single_eval_step for the
    single-frame model, at the narrow trimap width."""
    _hold_eval_step(eval_steps[name], _clip(4))


def test_eval_step_on_an_adobe_batch_matches_jax(eval_steps, tmp_path):
    """make_single_eval_step on one DIMEvalDataset batch (FBA, the resize
    grid of 64, the narrow trimap width), within
    test_eval_step_matches_jax's tolerances."""
    from tcvom_tpu_torch.data.dim import DIMEvalDataset

    make_adobe(str(tmp_path), n=1, hw=(70, 50), seed=2)
    item = DIMEvalDataset(data_root=str(tmp_path), val_mode="resize",
                          min_shape=H, plus1=False)[(0, 0)]
    batch = {k: item[k][None] for k in ("a", "fg", "bg")}
    assert batch["a"].shape == (1, 3, H, W, 1)
    tt = _hold_eval_step(eval_steps["fba"], batch)
    assert 0 < ((tt > 0) & (tt < 1)).float().mean() < 1


@pytest.mark.parametrize("name,dilation", [("vmn_fba", None), ("vmn_fba", 3),
                                           ("fba", None)])
def test_predict_test_folder_matches_jax(models, wild, tmp_path, name,
                                         dilation):
    jmod, jvars, port, _ = models[name]
    kw = dict(model=name, agg_window=WINDOW, dilate_radius=dilation)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    JP.predict_test_folder(jmod, jvars, JFM.TaskConfig(**kw), wild, jout)
    stats = TP.predict_test_folder(port, TFM.TaskConfig(**kw), wild, tout,
                                   device="cpu")
    assert stats["frames"] == 3
    assert {"prod_read", "main_step", "writer_imwrite"} <= set(stats)
    if name == "vmn_fba":
        assert {"prod_upload", "main_qget", "main_wqput",
                "writer_fetch"} <= set(stats)
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 3
    for fn in names:
        want = imread(os.path.join(jout, fn), IMREAD_GRAYSCALE)
        got = imread(os.path.join(tout, fn), IMREAD_GRAYSCALE)
        assert got.shape == WILD_HW
        _uint8_close(want, got)


def test_test_folder_matches_jax(wild):
    jf, tf = JP.TestFolder(wild), TP.TestFolder(wild)
    assert tf.names == jf.names
    for i in range(len(tf)):
        for w, g in zip(jf.read_frame(i), tf.read_frame(i)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        want, got = jf[i], tf[i]
        assert got["name"] == want["name"]
        for k in ("imgs", "tris", "orig_hw"):
            np.testing.assert_array_equal(got[k], want[k])


def test_write_pred_pngs_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    alphas = rng.uniform(-0.2, 1.2, (2, 40, 50, 1)).astype(np.float32)
    tris = rng.choice([0.0, 128 / 255, 1.0], (2, 40, 50, 1)).astype(
        np.float32)
    names = ["v/00001.png", "v/00002.png"]
    for crop in ((32, 48), [(40, 50), (33, 21)]):
        jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
        JP.write_pred_pngs(jdir, names, alphas, tris, crop_hw=crop)
        TP.write_pred_pngs(tdir, names, torch.from_numpy(alphas), tris,
                           crop_hw=crop)
        for n in ("00001_pred", "00001_tri", "00002_pred", "00002_tri"):
            w = imread(os.path.join(jdir, "v", n + ".png"),
                          IMREAD_UNCHANGED)
            g = imread(os.path.join(tdir, "v", n + ".png"),
                          IMREAD_UNCHANGED)
            np.testing.assert_array_equal(g, w)


def test_pipelines_need_a_card_or_an_explicit_cpu(models, wild, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = models["vmn_fba"][2]
    cfg = TFM.TaskConfig(model="vmn_fba", agg_window=WINDOW)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.predict_test_folder(port, cfg, wild, str(tmp_path))
    with pytest.raises(ValueError, match="single-frame"):
        TP.predict_test_folder(models["fba"][2], TFM.TaskConfig(model="fba"),
                               wild, str(tmp_path), dtype=torch.bfloat16,
                               device="cpu")
    # the JAX package's orbax checkpoints (directories) are not read
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_weights(port, str(tmp_path))
