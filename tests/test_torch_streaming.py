"""The slice end to end: the port's StreamingPredictor against the JAX
package's on a small f32 stream, with the same weights."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.infer.predict import StreamingPredictor as JSP
from tcvom_tpu.models import fba as JF
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu_torch.infer.predict import StreamingPredictor as TSP
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.train.trainer import MattingTrainer
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict

H = W = 64
LAYERS = (1, 1, 1, 1)
WINDOW = 3
FRAMES = 3


@pytest.fixture(scope="module")
def setup():
    jmod = JVMN(encoder=JF.FBAEncoder(layers=LAYERS),
                decoder=JF.FBADecoderVMN(), fam_channels=256,
                agg_window=WINDOW)
    x = jnp.zeros((1, 3, H, W, 11))
    masks = jnp.ones((1, 3, H, W, 1))
    extras = (jnp.zeros((1, 3, H, W, 3)), jnp.zeros((1, 3, H, W, 2)))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda: jmod.init(
        {"params": key, "dropout": key}, x, masks, extras=extras,
        train=False))()
    port = build_model("vmn_fba", agg_window=WINDOW, layers=LAYERS,
                       device="cpu")
    port.load_state_dict(jax_to_torch_state_dict("vmn_fba", variables))

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (FRAMES, 1, H, W, 3)).astype(np.uint8)
    tris = np.zeros((FRAMES, 1, H, W, 1), np.uint8)
    for i in range(FRAMES):                    # the trimap moves per frame
        tris[i, :, 20 + i:50 + i, 10:60] = 128
        tris[i, :, 30 + i:40 + i, 25:45] = 255
    return jmod, variables, port, imgs, tris


def _run(sp, imgs, tris):
    state, outs = None, []
    for img, tri in zip(imgs, tris):
        state, out = sp.step(state, img, tri)
        if out is not None:
            outs.append(out)
    outs.append(sp.flush(state))
    return outs


def _both(setup, **kw):
    jmod, variables, port, imgs, tris = setup
    jcfg = JFM.TaskConfig(model="vmn_fba", agg_window=WINDOW)
    tcfg = TFM.TaskConfig(model="vmn_fba", agg_window=WINDOW)
    want = _run(JSP(jmod, variables, jcfg, **kw), imgs, tris)
    got = _run(TSP(port, tcfg, device="cpu", **kw), imgs, tris)
    assert len(want) == len(got) == FRAMES
    return want, got


def test_streaming_alpha_matches_jax(setup):
    # GroupNorm statistics reassociate differently between the two
    # frameworks: the bound of tests/test_streaming.py
    want, got = _both(setup, fgbg=False, quantize=False)
    for w, g in zip(want, got):
        assert g.shape == (1, H, W, 1) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)


def test_streaming_quantized_matches_jax(setup):
    want, got = _both(setup, fgbg=False, quantize=True)
    for w, g in zip(want, got):
        assert g.shape == (1, H, W) and g.dtype == torch.uint8
        diff = np.abs(g.numpy().astype(int) - np.asarray(w).astype(int))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99


def test_streaming_fgbg_matches_jax(setup):
    want, got = _both(setup, fgbg=True, quantize=False)
    for w, g in zip(want, got):
        for wt, gt in zip(w, g):
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=5e-4)


def test_streaming_single_frame_clip(setup):
    jmod, variables, port, imgs, tris = setup
    jsp = JSP(jmod, variables, JFM.TaskConfig(model="vmn_fba",
                                              agg_window=WINDOW),
              fgbg=False)
    tsp = TSP(port, TFM.TaskConfig(model="vmn_fba", agg_window=WINDOW),
              fgbg=False, device="cpu")
    want = jsp.flush(jsp.step(None, imgs[0], tris[0])[0])
    got = tsp.flush(tsp.step(None, imgs[0], tris[0])[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


def test_streaming_bf16_pastes_trimap(setup):
    _, _, port, imgs, tris = setup
    sp = TSP(port, TFM.TaskConfig(model="vmn_fba", agg_window=WINDOW),
             dtype=torch.bfloat16, fgbg=False, quantize=True, device="cpu")
    assert next(port.parameters()).dtype == torch.float32   # a copy is cast
    outs = _run(sp, imgs, tris)
    for out, tri in zip(outs, tris):
        assert out.shape == (1, H, W) and out.dtype == torch.uint8
        known = tri[..., 0] != 128
        np.testing.assert_array_equal(out.numpy()[known], tri[..., 0][known])


def test_entry_points_need_a_card_or_an_explicit_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("vmn_fba", layers=LAYERS)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSP(setup[2], TFM.TaskConfig(model="vmn_fba"), fgbg=False)
    # the trainer, for GCA too (it trains since BatchNorm's update and the
    # power iteration were ported)
    with pytest.raises(RuntimeError, match="CUDA"):
        MattingTrainer(TFM.TaskConfig(model="vmn_gca"), "vmd")
