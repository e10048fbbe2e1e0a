"""The port's FBA modules against the JAX package's, with the JAX-initialised
weights carried over by ``jax_to_torch_state_dict``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.models import fba as JF
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.utils.convert import convert_state_dict
from tcvom_tpu_torch.models.fba import FBAEncoder
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict

H = W = 64
LAYERS = (1, 1, 1, 1)
TOL = dict(atol=1e-4, rtol=1e-4)


def jax_vmn_fba(layers=LAYERS, window=3):
    return JVMN(encoder=JF.FBAEncoder(layers=layers),
                decoder=JF.FBADecoderVMN(), fam_channels=256,
                agg_window=window)


def init_jax_vmn(module, h=H, w=W):
    x = jnp.zeros((1, 3, h, w, 11))
    masks = jnp.ones((1, 3, h, w, 1))
    extras = (jnp.zeros((1, 3, h, w, 3)), jnp.zeros((1, 3, h, w, 2)))
    key = jax.random.PRNGKey(0)
    return jax.jit(lambda: module.init({"params": key, "dropout": key}, x,
                                       masks, extras=extras, train=False))()


@pytest.fixture(scope="module")
def models():
    jmod = jax_vmn_fba()
    variables = init_jax_vmn(jmod)
    port = build_model("vmn_fba", agg_window=3, layers=LAYERS, device="cpu")
    port.load_state_dict(jax_to_torch_state_dict("vmn_fba", variables))
    return jmod, variables, port


def _t(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _n(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,planes,stride,dil,cin", [
    ("layer1_0", 64, 1, 1, 64), ("layer2_0", 128, 2, 1, 256),
    ("layer4_0", 512, 1, 2, 1024)])
def test_bottleneck_matches_jax(models, rng, name, planes, stride, dil, cin):
    _, variables, port = models
    x = rng.randn(1, 8, 8, cin).astype(np.float32)
    want = JF.Bottleneck(planes, stride, dil, downsample=True).apply(
        {"params": variables["params"]["encoder"][name]}, jnp.asarray(x))
    layer, idx = name.split("_")
    got = getattr(port.encoder, layer)[int(idx)](_t(x))
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


def _encoder_input(rng):
    x = rng.randn(1, H, W, 11).astype(np.float32)
    img = rng.rand(1, H, W, 3).astype(np.float32)
    two = (rng.rand(1, H, W, 2) > 0.7).astype(np.float32)
    return x, img, two


def test_encoder_matches_jax(models, rng):
    _, variables, port = models
    x, _, _ = _encoder_input(rng)
    want = JF.FBAEncoder(layers=LAYERS).apply(
        {"params": variables["params"]["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.encoder(_t(x))
    assert len(got["conv_out"]) == len(want["conv_out"]) == 6
    for g, w in zip(got["conv_out"], want["conv_out"]):
        np.testing.assert_allclose(_n(g), np.asarray(w), **TOL)


def test_encoder_later_blocks_match_jax(rng):
    """Blocks after the first of layer3 and layer4, whose 3x3 convs take
    the second dilation (2 and 4), which layers=(1,1,1,1) never builds."""
    layers = (1, 1, 2, 2)
    x = rng.randn(1, 32, 32, 11).astype(np.float32)
    jenc = JF.FBAEncoder(layers=layers)
    params = jax.jit(lambda: jenc.init(jax.random.PRNGKey(1),
                                       jnp.zeros(x.shape)))()["params"]
    sd = jax_to_torch_state_dict("vmn_fba", {"params": {"encoder": params}})
    port = FBAEncoder(layers=layers)
    port.load_state_dict({k.removeprefix("encoder."): v for k, v in sd.items()})
    want = jenc.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(_t(x))
    for g, w in zip(got["conv_out"], want["conv_out"]):
        np.testing.assert_allclose(_n(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("mode", ["extract", "head"])
def test_decoder_matches_jax(models, rng, mode):
    _, variables, port = models
    x, img, two = _encoder_input(rng)
    enc_j = JF.FBAEncoder(layers=LAYERS).apply(
        {"params": variables["params"]["encoder"]}, jnp.asarray(x))
    enc_j = dict(enc_j, extras=(jnp.asarray(img), jnp.asarray(two)))
    enc_t = {"conv_out": tuple(_t(c) for c in enc_j["conv_out"]),
             "extras": (_t(img), _t(two))}
    feat = rng.randn(1, H // 8, W // 8, 256).astype(np.float32)
    kw = {"x": jnp.asarray(feat)} if mode == "head" else {}
    want = JF.FBADecoderVMN().apply(
        {"params": variables["params"]["decoder"]}, enc_j, mode=mode, **kw)
    with torch.no_grad():
        got = port.decoder(enc_t, mode=mode,
                           x=_t(feat) if mode == "head" else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)
    if mode == "head":
        # the head reads only what prune_enc_head keeps
        with torch.no_grad():
            pruned = port.decoder(type(port.decoder).prune_enc_head(enc_t),
                                  mode="head", x=_t(feat))
        assert torch.equal(pruned, got)


def test_vmn_encode_decode_qkv_matches_jax(models, rng):
    jmod, variables, port = models
    frames = [_encoder_input(rng) for _ in range(3)]
    mask = (rng.rand(1, H, W, 1) > 0.5).astype(np.float32)
    encs_j, encs_t = [], []
    for x, img, two in frames:
        encs_j.append(jmod.apply(variables, jnp.asarray(x),
                                 extras=(jnp.asarray(img), jnp.asarray(two)),
                                 method=JVMN.encode_extract_qkv))
        with torch.no_grad():
            encs_t.append(port.encode_extract_qkv(
                _t(x), extras=(_t(img), _t(two))))
    for (_, qj), (_, qt) in zip(encs_j, encs_t):
        for key in ("q", "k", "v"):
            np.testing.assert_allclose(_n(qt[key]), np.asarray(qj[key]),
                                       **TOL, err_msg=key)
    want, _, _, want_mask = jmod.apply(
        variables, encs_j[1][0], encs_j[1][1], encs_j[0][1]["k"],
        encs_j[2][1]["k"], jnp.asarray(mask), need_logits=False,
        method=JVMN.decode_window_qkv)
    with torch.no_grad():
        got, attb, attf, got_mask = port.decode_window_qkv(
            encs_t[1][0], encs_t[1][1], encs_t[0][1]["k"], encs_t[2][1]["k"],
            _t(mask))
    assert attb is None and attf is None
    np.testing.assert_array_equal(_n(got_mask), np.asarray(want_mask))
    np.testing.assert_allclose(_n(got), np.asarray(want), **TOL)


def test_state_dict_round_trip_through_jax_converter(models):
    _, variables, port = models
    back, unmatched = convert_state_dict("vmn_fba", port.state_dict())
    assert unmatched == []
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_jax_to_torch_rejects_unknown_leaf(models):
    _, variables, _ = models
    bad = {"params": dict(variables["params"], stray={"kernel": np.zeros(1)})}
    with pytest.raises(KeyError, match="stray"):
        jax_to_torch_state_dict("vmn_fba", bad)
