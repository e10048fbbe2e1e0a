"""GCA's pieces in the port against the JAX package's, on the CPU: the
spectral-norm conv and its transposed form (eval forward, one train-mode
power iteration, the weight's gradient), the reflection pad, the patch
extraction, the stride-2 overlap-add and the guided attention core, and
the port's initialisers. The models themselves are held in
``tests/test_torch_gca_model.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.models.layers import SNConv as JSNConv
from tcvom_tpu.ops import gca_attention as JA
from tcvom_tpu.ops import image as JI
from tcvom_tpu_torch.models import gca as TG
from tcvom_tpu_torch.models.layers import SNConv2d
from tcvom_tpu_torch.models.registry import (build_model,
                                             calibrate_random_weights,
                                             converge_spectral_norms)
from tcvom_tpu_torch.ops import gca_attention as TA
from tcvom_tpu_torch.ops import image as TI
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict


def _t(a):
    """NHWC numpy -> NCHW torch (a copy)."""
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


def _n(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# spectral-norm convs
# ---------------------------------------------------------------------------

# (JAX module, input NHWC, the JAX path whose converter rule carries it)
_SN_CASES = {
    "conv": (dict(features=7, kernel_size=3, strides=2, padding=1),
             (2, 9, 10, 5), "encoder/conv1"),
    "transpose": (dict(features=4, kernel_size=4, strides=2, padding=1,
                       transpose=True), (2, 5, 6, 6), "decoder/conv1"),
}


def _sn_pair(kind: str, rng):
    """The JAX SNConv's variables, its ``u`` and ``v`` moved off the
    leading singular vectors (so that one power iteration moves them and
    sigma stays near the spectral norm), and the port's SNConv2d with the
    same weights through the GCA converter's rule for ``path``."""
    kw, shape, path = _SN_CASES[kind]
    jmod = JSNConv(**kw)
    x = rng.randn(*shape).astype(np.float32)
    variables = jmod.init({"params": jax.random.PRNGKey(3)}, x)
    kernel = np.asarray(variables["params"]["kernel_bar"])
    # the flattening of the JAX module: [out, in*kh*kw] or [in, out*kh*kw]
    order = (2, 3, 0, 1) if kw.get("transpose") else (3, 2, 0, 1)
    wmat = np.transpose(kernel, order).reshape(kernel.shape[order[0]], -1)
    u, _, vh = np.linalg.svd(wmat.astype(np.float64), full_matrices=False)
    spectral = {}
    for name, vec in (("u", u[:, 0]), ("v", vh[0])):
        vec = vec + 0.3 * rng.randn(*vec.shape) / np.sqrt(vec.size)
        spectral[name] = (vec / np.linalg.norm(vec)).astype(np.float32)
    variables = {"params": variables["params"], "spectral": spectral}
    prefix = path.split("/")
    nested = {coll: {prefix[0]: {prefix[1]: tree}}
              for coll, tree in variables.items()}
    sd = jax_to_torch_state_dict("gca", nested)
    port = SNConv2d(shape[-1], kw["features"], kw["kernel_size"],
                    kw["strides"], kw["padding"],
                    transpose=kw.get("transpose", False))
    port.load_state_dict({k.removeprefix(path.replace("/", ".") + "."): v
                          for k, v in sd.items()})
    return jmod, variables, port, x


@pytest.mark.parametrize("kind", list(_SN_CASES))
def test_sn_conv_eval_matches_jax(rng, kind):
    jmod, variables, port, x = _sn_pair(kind, rng)
    want = jmod.apply(variables, x, False)
    got = port.eval()(_t(x))
    assert got.shape == (x.shape[0], want.shape[-1]) + want.shape[1:3]
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5, rtol=0)
    # eval mode reads u and v and leaves them
    np.testing.assert_array_equal(port.module.weight_u.numpy(),
                                  variables["spectral"]["u"])


@pytest.mark.parametrize("kind", list(_SN_CASES))
def test_sn_conv_train_step_matches_jax(rng, kind):
    """One train-mode call: the power iteration's new u and v against the
    JAX ``spectral`` collection, and the output with the new sigma."""
    jmod, variables, port, x = _sn_pair(kind, rng)
    want, upd = jmod.apply(variables, x, True, mutable=["spectral"])
    got = port.train()(_t(x))
    for name in ("u", "v"):
        new = getattr(port.module, f"weight_{name}").numpy()
        assert np.abs(new - variables["spectral"][name]).max() > 1e-3
        np.testing.assert_allclose(new, np.asarray(upd["spectral"][name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", list(_SN_CASES))
def test_sn_conv_weight_gradient_matches_jax(rng, kind):
    """The gradient of a train-mode call reaches ``weight_bar`` through the
    conv and through sigma (u and v held): JAX's kernel gradient in the
    port's layout."""
    jmod, variables, port, x = _sn_pair(kind, rng)
    cot = rng.randn(*jmod.apply(variables, x, False).shape).astype(
        np.float32)

    def loss(params):
        y, _ = jmod.apply({"params": params,
                           "spectral": variables["spectral"]}, x, True,
                          mutable=["spectral"])
        return jnp.sum(y * cot)

    want = jax.grad(loss)(variables["params"])["kernel_bar"]
    y = port.train()(_t(x))
    (y * _t(cot)).sum().backward()
    order = (2, 3, 0, 1) if kind == "transpose" else (3, 2, 0, 1)
    np.testing.assert_allclose(port.module.weight_bar.grad.numpy(),
                               np.transpose(np.asarray(want), order),
                               atol=1e-5, rtol=1e-5)


def test_sn_conv_keeps_sigma_in_f32():
    """A bf16 conv: bf16 output, the weight normalized by an f32 sigma
    (rounded once, to the conv's dtype)."""
    conv = SNConv2d(4, 6, 3, 1, 1).eval()
    torch.nn.init.normal_(conv.module.weight_bar)
    conv.to(torch.bfloat16)
    x = torch.randn(1, 4, 5, 5).to(torch.bfloat16)
    w = conv.module.weight_bar.float()
    u, v = conv.module.weight_u.float(), conv.module.weight_v.float()
    sigma = u @ (w.reshape(6, -1) @ v)
    assert conv.sigma().dtype == torch.float32
    torch.testing.assert_close(conv.sigma(), sigma)
    want = torch.nn.functional.conv2d(x, (w / sigma).to(torch.bfloat16),
                                      padding=1)
    got = conv(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the attention's pieces
# ---------------------------------------------------------------------------

def test_reflection_pad_matches_jax(rng):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    for pad in (1, 2):
        np.testing.assert_array_equal(_n(TI.reflection_pad(_t(x), pad)),
                                      np.asarray(JI.reflection_pad(x, pad)))


@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, 2)])
def test_extract_patches_reflect_matches_jax(rng, kernel, stride):
    """The port's ``[B, C*k*k, N]`` is JAX's ``[B, N, k*k, C]`` reordered,
    value for value."""
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    want = np.asarray(JA.extract_patches_reflect(x, kernel, stride))
    got = TA.extract_patches_reflect(_t(x), kernel, stride)
    b, c = x.shape[0], x.shape[-1]
    got = got.reshape(b, c, kernel * kernel, -1).permute(0, 3, 2, 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_overlap_add_matches_jax(rng):
    z = rng.randn(2, 3, 5, 4, 4, 6).astype(np.float32)
    want = np.asarray(JA.overlap_add_stride2_k4(z))
    zt = torch.from_numpy(z).permute(0, 5, 3, 4, 1, 2).reshape(2, 6 * 16,
                                                               3 * 5)
    got = TA.overlap_add_stride2_k4(zt, (3, 5))
    assert got.shape == (2, 6, 6, 10)
    np.testing.assert_allclose(_n(got), want, atol=1e-5, rtol=0)


def _unknown(rng, kind: str, shape):
    if kind == "all_unknown":
        return np.ones(shape, np.float32)
    if kind == "all_known":
        return np.zeros(shape, np.float32)
    u = np.zeros(shape, np.float32)
    u[:, 1:4, 2:6] = 1.0
    u[1, 4:, :3] = 1.0
    return u


def _core_inputs(rng, kind):
    """Guidance features [2, 6, 8, 16] (N = 48), alpha features
    [2, 12, 16, 8], the unknown mask at the guidance grid."""
    f = (0.3 * rng.randn(2, 6, 8, 16)).astype(np.float32)
    alpha = rng.randn(2, 12, 16, 8).astype(np.float32)
    return f, alpha, _unknown(rng, kind, (2, 6, 8, 1))


@pytest.mark.parametrize("kind,has_unknown", [
    ("mixed", True), ("all_unknown", True), ("all_known", True),
    ("mixed", False)])
def test_guided_attention_core_matches_jax(rng, kind, has_unknown):
    """A mixed mask, an all-unknown mask (um = 1) and an all-known one
    (um = 0), and the branch without the unknown region (softmax_scale
    0.7, every patch self-masked)."""
    f, alpha, unk = _core_inputs(rng, kind)
    kw = dict(softmax_scale=0.7, has_unknown=has_unknown)
    want = np.asarray(JA.guided_attention_core(f, alpha, unk, **kw))
    got = TA.guided_attention_core(_t(f), _t(alpha), _t(unk), **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 12, 16)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(_n(got), want, atol=1e-5, rtol=0)


def test_guided_attention_core_bf16_keeps_f32_logits(rng):
    """bf16 inputs: f32 output, near the f32 run on the same bf16 values
    (the products' inputs are bf16, the softmax weights rounded to bf16
    before the reconstruction)."""
    f, alpha, unk = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (_t(x).numpy() for x in _core_inputs(rng,
                                                                   "mixed")))
    got = TA.guided_attention_core(f, alpha, unk)
    want = TA.guided_attention_core(f.float(), alpha.float(), unk.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# the port's initialisers
# ---------------------------------------------------------------------------

def test_init_weights_follow_jax():
    """build_model's GCA draws the JAX package's initialisation
    (tcvom_tpu/models/gca.py:30-68, tcvom_tpu/models/layers.py:150-162):
    the encoder conv1's trimap input channels zero, every residual block's
    bn2 scale 0, the attentions' W BatchNorm scale 1e-3, unit u and v."""
    model = build_model("vmn_gca", agg_window=3, device="cpu")
    enc, dec = model.encoder, model.decoder
    w1 = enc.conv1.module.weight_bar
    assert w1.shape == (32, 6, 3, 3) and not w1[:, :3].eq(0).any()
    assert w1[:, 3:].eq(0).all()
    blocks = [m for m in model.modules()
              if isinstance(m, (TG.EncBasicBlock, TG.DecBasicBlock))]
    assert len(blocks) == 13 + 10
    assert all(b.bn2.weight.eq(0).all() for b in blocks)
    for gca in (enc.gca, dec.gca):
        assert torch.all(gca.W[1].weight == 1e-3)
    sns = [m for m in model.modules() if isinstance(m, SNConv2d)]
    for m in sns:
        for vec in (m.module.weight_u, m.module.weight_v):
            torch.testing.assert_close(torch.linalg.vector_norm(vec),
                                       torch.tensor(1.0))
    # xavier-uniform bound sqrt(6 / (fan_in + fan_out))
    w = dec.layer1[0].conv1.module.weight_bar            # IOHW, 512 -> 512
    assert w.shape == (512, 512, 4, 4)
    assert w.abs().max() <= (6 / (2 * 512 * 16)) ** 0.5
    assert dec.layer1[0].conv1.transpose and not dec.layer1[0].conv2.transpose


def test_calibration_leaves_spectral_norm_convs(rng):
    """After converge_spectral_norms each conv's u and v are a fixed point
    of the power iteration with a positive sigma no random direction
    exceeds; calibrate_random_weights then sets the BatchNorms' statistics
    and scales the plain convs, but leaves every spectral-norm conv as it
    was."""
    model = build_model("gca", device="cpu")
    converge_spectral_norms(model)
    sns = [m for m in model.modules() if isinstance(m, SNConv2d)]
    assert len(sns) == 70
    for m in sns:
        u, v = m.module.weight_u.clone(), m.module.weight_v.clone()
        m.power_iteration()
        torch.testing.assert_close(m.module.weight_u, u, atol=1e-5, rtol=0)
        torch.testing.assert_close(m.module.weight_v, v, atol=1e-5, rtol=0)
        x = torch.randn(v.shape[0], 4)
        wmat = m.module.weight_bar.reshape(u.shape[0], -1)
        assert m.sigma() > 0
        assert torch.all((wmat @ x).norm(dim=0) <= m.sigma() * x.norm(dim=0))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if ".module." in k}
    x = torch.from_numpy(rng.randn(2, 6, 64, 64).astype(np.float32))
    calibrate_random_weights(model, lambda: model(x))
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not torch.equal(after["encoder.bn1.running_var"],
                           torch.ones(32))
    assert not model.training and not any(m.training for m in sns)
