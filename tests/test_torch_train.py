"""The port's training slice against the JAX package, on the CPU: trimap
synthesis, the video loss stack and its gradients, the optimizers and
schedules, the frozen-backbone filter and the validation step. Weights
are JAX-initialised and carried over by ``jax_to_torch_state_dict``; the
random trimap radius is the one JAX draws, handed to the port."""
import unittest.mock as mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tcvom_tpu.models import fba as JF
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models import layers as JL
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.ops import image as JI
from tcvom_tpu.ops import losses as JLo
from tcvom_tpu.train import trainer as JT
from tcvom_tpu.train.state import TrainState as JState
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.train import trainer as TT
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict

H = W = 64
LAYERS = (1, 1, 1, 1)
WINDOW = 3
KEY = jax.random.PRNGKey(7)


def _clip(rng, b, s, h=H, w=W):
    """Soft-edged discs moving across the clip (0 and 255 inside and out,
    a non-empty unknown band between), noise fg and bg, all 0..255."""
    yy, xx = np.mgrid[:h, :w]
    a = np.zeros((b, s, h, w, 1), np.float32)
    for i in range(b):
        for t in range(s):
            cy, cx = h / 2 + 3 * t - 4 * i, w / 2 + 2 * t + 5 * i
            d = np.hypot(yy - cy, xx - cx)
            a[i, t, ..., 0] = np.clip((h / 4 - d) / 4.0, 0.0, 1.0) * 255.0
    fg = (rng.rand(b, s, h, w, 3) * 255).astype(np.float32)
    bg = (rng.rand(b, s, h, w, 3) * 255).astype(np.float32)
    return {"a": a, "fg": fg, "bg": bg}


def _jax_radius(key, b):
    """The radius JAX's forward drivers draw from ``key`` (a copy: torch
    must not share JAX's buffer)."""
    kp, _ = jax.random.split(key)
    return np.array(jax.random.randint(kp, (b,), 0, 26))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_model():
    module = JVMN(encoder=JF.FBAEncoder(layers=LAYERS),
                  decoder=JF.FBADecoderVMN(), fam_channels=256,
                  agg_window=WINDOW)
    x = jnp.zeros((1, 3, H, W, 11))
    masks = jnp.ones((1, 3, H, W, 1))
    extras = (jnp.zeros((1, 3, H, W, 3)), jnp.zeros((1, 3, H, W, 2)))
    variables = jax.jit(lambda: module.init(
        {"params": KEY, "dropout": KEY}, x, masks, extras=extras,
        train=False))()
    return module, variables


def _port_trainer(variables, **kw):
    cfg = TFM.TaskConfig(model="vmn_fba", agg_window=WINDOW,
                         freeze_backbone=kw.pop("freeze_backbone", False))
    tr = TT.MattingTrainer(cfg, "vmd", layers=LAYERS, device="cpu", **kw)
    state = tr.init_state(torch.Generator().manual_seed(1))
    state.model.load_state_dict(jax_to_torch_state_dict("vmn_fba", variables))
    return tr, state


# -- trimap synthesis ---------------------------------------------------------

@pytest.mark.parametrize("model,eps,dilate", [
    ("vmn_fba", 0.0, None), ("vmn_dim", 0.0, None), ("vmn_gca", 0.0, None),
    ("vmn_fba", 1e-2, None), ("vmn_fba", 0.0, 4)])
def test_preprocess_matches_jax(rng, model, eps, dilate):
    batch = _clip(rng, 3, 2)
    key = jax.random.PRNGKey(3)
    radius = np.array(jax.random.randint(key, (3,), 0, 26))
    want = JFM.preprocess(key, *(jnp.asarray(batch[k]) for k in
                                 ("a", "fg", "bg")),
                          JFM.TaskConfig(model=model, eps=eps,
                                         dilate_radius=dilate))
    got = TFM.preprocess(*(torch.from_numpy(batch[k]) for k in
                           ("a", "fg", "bg")),
                         TFM.TaskConfig(model=model, eps=eps,
                                        dilate_radius=dilate),
                         radius=torch.from_numpy(radius))
    assert set(got) == set(want)
    for key_ in got:
        g, w = got[key_].numpy(), np.asarray(want[key_])
        assert g.shape == w.shape, key_
        if key_ == "tris" and model == "vmn_fba":
            np.testing.assert_array_equal(g[..., 6:], w[..., 6:])
            np.testing.assert_allclose(g[..., :6], w[..., :6], atol=1e-6)
        elif key_ in ("tris", "trimasks"):
            np.testing.assert_array_equal(g, w, err_msg=key_)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=key_)


def test_make_trimap_needs_a_radius_when_random(rng):
    alpha = torch.from_numpy(_clip(rng, 1, 1)["a"]) / 255.0
    with pytest.raises(ValueError, match="radius"):
        TFM.make_trimap(alpha, TFM.TaskConfig(model="vmn_fba"))


# -- the video loss stack and its gradients -----------------------------------

def _port_vmd_grads(model, batch, cfg, radius):
    model.train()
    losses, _ = TFM.forward_vmd(model, batch, cfg, radius)
    sum(TT.LOSS_WEIGHTS_VMD[k] * v for k, v in losses.items()).backward()
    return losses, {n: p.grad.double().numpy()
                    for n, p in model.named_parameters()}


class _WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``: patched into the
    JAX modules below, it widens their hard-coded f32 islands (GroupNorm
    statistics, weight standardization, the FBA head, resize weights, the
    Laplacian kernel) so that an x64 forward is f64 throughout."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_vmd_grads(module, params, batch, cfg):
    def loss_fn(params):
        losses, _, _ = JFM.forward_vmd(module, {"params": params}, KEY,
                                       _jax_batch(batch), cfg, train=True)
        total = sum(JT.LOSS_WEIGHTS_VMD[k] * v for k, v in losses.items())
        return total, losses

    (_, losses), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return losses, {n: t.double().numpy() for n, t in jax_to_torch_state_dict(
        "vmn_fba", {"params": grads}).items()}


@pytest.fixture(scope="module")
def vmd_step(jax_model):
    """One forward_vmd with gradients on each side, same weights, batch and
    radius (B=1, S=5, 64x64, window 3), in f32 and again in f64 (x64 with
    the JAX modules' f32 islands widened, the port's model in double).
    Under x64 JAX draws a different radius from KEY; the port is given
    the one JAX draws in each mode."""
    module, variables = jax_model
    batch = _clip(np.random.RandomState(5), 1, 5)
    cfg_j = JFM.TaskConfig(model="vmn_fba", agg_window=WINDOW)
    want_losses, want32 = _jax_vmd_grads(module, variables["params"], batch,
                                         cfg_j)
    wide = _WideJnp()
    with jax.enable_x64(True), mock.patch.object(JL, "jnp", wide), \
            mock.patch.object(JF, "jnp", wide), \
            mock.patch.object(JFM, "jnp", wide), \
            mock.patch.object(JI, "jnp", wide), \
            mock.patch.object(JLo, "jnp", wide):
        params64 = jax.tree.map(lambda a: jnp.asarray(np.array(a),
                                                      jnp.float64),
                                variables["params"])
        _, want64 = _jax_vmd_grads(
            module, params64, {k: v.astype(np.float64)
                               for k, v in batch.items()}, cfg_j)
        radius64 = torch.from_numpy(_jax_radius(KEY, 1))

    tr, state = _port_trainer(variables)
    losses, got32 = _port_vmd_grads(
        state.model, _torch_batch(batch), tr.cfg,
        torch.from_numpy(_jax_radius(KEY, 1)))
    state.model.zero_grad(set_to_none=True)
    _, got64 = _port_vmd_grads(
        state.model.double(),
        {k: v.double() for k, v in _torch_batch(batch).items()}, tr.cfg,
        radius64)
    return losses, want_losses, (got32, want32), (got64, want64)


@pytest.mark.parametrize("term", ["L1", "L2", "L3", "L_dt", "L_att"])
def test_forward_vmd_losses_match_jax(vmd_step, term):
    got, want = vmd_step[0][term], vmd_step[1][term]
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)


@pytest.mark.parametrize("part", ["encoder.", "decoder.ppm.",
                                  "decoder.conv_up", "decoder.fam."])
def test_forward_vmd_gradients_match_jax(vmd_step, part):
    """Each parameter's gradient against jax.grad, as relative L2 error:
    in f64 within 1e-6 for every parameter; in f32 within 1e-3 for the
    decoder's and the FAM's. The f32 encoder gradients are held in f64
    only: a few ReLU masks and max-pool choices in the encoder whose
    inputs lie within f32 rounding of a tie flip between the port's f32
    and f64 runs, and each flip moves the gradients of the parameters
    below it by more than 1e-3 at this size."""
    _, _, (got32, want32), (got64, want64) = vmd_step
    names = [n for n in got32 if n.startswith(part)]
    assert names
    for name in names:
        scale = np.linalg.norm(want64[name])
        err = np.linalg.norm(got64[name] - want64[name])
        assert err <= 1e-6 * scale, (name, err, scale)
        if part != "encoder.":
            err = np.linalg.norm(got32[name] - want32[name])
            scale = np.linalg.norm(want32[name])
            assert err <= 1e-3 * scale, (name, err, scale)


# -- optimizers, schedules, the frozen set -------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("strategy", ["poly", "const"])
def test_optimizer_and_schedule_match_optax(rng, name, strategy):
    """The slice's lr and weight decay (1e-4 each). Optax forms Adam's
    bias corrections in f32 and torch in f64, ~1e-5 of an update apart:
    far inside atol 1e-7 at this lr, far outside it at lr 1e-2."""
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    lr, wd, total = 1e-4, 1e-4, 4
    sched = JT.make_lr_schedule(strategy, lr, total)
    tx = JT.make_optimizer(name, sched, wd)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    t_sched = TT.make_lr_schedule(strategy, lr, total)
    opt = TT.make_optimizer(name, tp, wd)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        np.testing.assert_allclose(t_sched(step), float(sched(step)),
                                   rtol=1e-6)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        for group in opt.param_groups:
            group["lr"] = t_sched(step)
        opt.step()
    for got, want, start in zip(tp, jp, params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-7)
        assert np.abs(got.detach().numpy() - start).max() > 1e-5


def test_trainable_mask_matches_jax(jax_model):
    _, variables = jax_model
    params = variables["params"]
    mask = JT.trainable_mask(params, "vmn_fba", True)
    flags = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32),
                         params, mask)
    want_frozen = {n for n, t in jax_to_torch_state_dict(
        "vmn_fba", {"params": flags}).items() if not t.any()}
    _, state = _port_trainer(variables, freeze_backbone=True)
    got = TT.trainable_mask(state.model, True)
    assert {n for n, keep in got.items() if not keep} == want_frozen
    assert any(n.startswith("decoder.conv_up1.") for n in want_frozen)
    assert all(TT.trainable_mask(state.model, False).values())


def test_frozen_backbone_gets_no_update_and_no_decay(jax_model, rng):
    """Frozen parameters stay out of the optimizer: with weight decay on,
    a step leaves them bit for bit as they were and gives them no grad."""
    _, variables = jax_model
    tr, state = _port_trainer(variables, freeze_backbone=True,
                              weight_decay=1e-2)
    keep = TT.trainable_mask(state.model, True)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == sum(keep.values()) < len(keep)
    batch = _torch_batch({k: v[:, :3] for k, v in
                          _clip(rng, 1, 3).items()})
    state, metrics = tr.train_step(state, batch)
    assert state.step == 1 and np.isfinite(metrics["loss"].item())
    for n, p in state.model.named_parameters():
        if keep[n]:
            assert p.grad is not None, n
        else:
            assert p.grad is None and torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n])
               for n, p in state.model.named_parameters() if keep[n])


# -- validation and the trainer's steps ----------------------------------------

def test_val_dt_step_matches_jax(jax_model):
    module, variables = jax_model
    batch = _clip(np.random.RandomState(9), 2, 3)
    jtr = JT.MattingTrainer(JFM.TaskConfig(model="vmn_fba",
                                           agg_window=WINDOW), "vmd")
    jtr.module = module
    jstate = JState(step=jnp.zeros((), jnp.int32),
                    params=variables["params"], model_state={}, opt_state=())
    want, (want_a, want_vis, want_gt) = jtr.val_dt_step(
        jstate, _jax_batch(batch), KEY)
    tr, state = _port_trainer(variables)
    got, (got_a, got_vis, got_gt) = tr.val_dt_step(
        state, _torch_batch(batch),
        radius=torch.from_numpy(_jax_radius(KEY, 2)))
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    assert got_a.shape == want_a.shape


def test_trainer_steps_run_and_count(jax_model, rng):
    """train_step advances the step and the poly lr (lr(0) first);
    eval_step, vis_step and forward_single run on the same state."""
    _, variables = jax_model
    tr, state = _port_trainer(variables, lr_strategy="poly", base_lr=1e-4,
                              total_iters=10)
    batch = _torch_batch(_clip(rng, 1, 5))
    lrs = []
    for _ in range(2):
        state, metrics = tr.train_step(state, batch)
        lrs.append(metrics["lr"])
        assert set(metrics) == {"loss", "L1", "L2", "L3", "L_dt", "L_att",
                                "lr"}
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 2 and lrs == [1e-4, 1e-4 * 0.9 ** 0.9]
    losses, alphas = tr.eval_step(state, batch, radius=torch.tensor([2]))
    assert alphas.shape == (1, 5, H, W, 1) and not alphas[:, 0].any()
    vis = tr.vis_step(state, batch)
    assert vis["Fs"].shape == (1, 5, H, W, 3)
    single, _ = TFM.forward_single(state.model, batch, tr.cfg,
                                   torch.tensor([2]))
    for k in ("L1", "L2", "L3"):
        np.testing.assert_allclose(single[k].item(), losses[k].item(),
                                   rtol=1e-6)


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    cfg = TFM.TaskConfig(model="vmn_fba")
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.MattingTrainer(cfg, "vmd")
        TT.MattingTrainer(cfg, "vmd", device="cpu")
