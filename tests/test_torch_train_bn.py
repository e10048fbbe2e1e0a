"""The port's training step for the BatchNorm backbones against the JAX
package's, on the CPU: the BatchNorm layer's training update (biased
variance, as flax), one ``MattingTrainer.train_step`` of ``vmn_index``
(vmd driver, B = 1, S = 3, 64x64, window 3; ``vmn_dim``'s runs the same
checks in test_torch_train_dim.py, on another worker) against JAX's
``forward_vmd(train=True, mutable=["batch_stats"])`` gradient (losses,
gradients, every BatchNorm's new running statistics, IndexNet's ASPP
pooled branch by name), IndexNet's dropout, the frozen-backbone filter of
all eight models and ``VMN.train``.

Weights: the port's model, calibrated (``calibrate_random_weights``) and
given random BatchNorm statistics, carried to JAX through its own
converter over a ``jax.eval_shape`` of the init (no init compile). The
trimap radius is the one JAX draws. IndexNet's Dropout is the identity on
both sides in the parity steps (flax's ``nn.intercept_methods``, the
port's module in eval mode); its own test holds it live."""
import contextlib
import unittest.mock as mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from tcvom_tpu.models import dim as JD
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models import layers as JL
from tcvom_tpu.models import registry as JR
from tcvom_tpu.ops import image as JI
from tcvom_tpu.ops import losses as JLo
from tcvom_tpu.train import trainer as JT
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models import layers as TL
from tcvom_tpu_torch.models.registry import (build_model,
                                             calibrate_random_weights)
from tcvom_tpu_torch.train import trainer as TT
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict
from test_torch_dim import _frames, carried, randomize_batchnorms

H = W = 64
WINDOW = 3
KEY = jax.random.PRNGKey(7)
# the parity steps' clip length (B = 1)
S = 3
# IndexNet's ASPP global-pool branch: its BatchNorm sees one value a
# channel per frame, n = B * S = 3, so the biased and unbiased updates of
# its running variance differ by 3/2
POOLED_BN = "encoder.dconv_pp.global_avg_pool.2"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread while the module runs:
    beside the test run's other workers, many threads per process stall
    each other, and IndexNet's many small convolutions most (ROADMAP.md,
    "LAPACK on shared cores")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the BatchNorm layer ----------------------------------------------------

@pytest.mark.parametrize("n", [2, 5, 40])
@pytest.mark.parametrize("jax_bn", ["flax", "raw"])
def test_batchnorm_training_update_matches_jax(rng, n, jax_bn):
    """Two training calls then one in eval: outputs and running statistics
    against flax's nn.BatchNorm (the backbones') and RawBatchNorm; the
    running variance takes the biased batch variance."""
    c = 6
    xs = [rng.randn(n, c, 3, 2).astype(np.float64) * 3 + 1 for _ in range(3)]
    scale, bias = rng.uniform(0.5, 1.5, c), rng.randn(c)
    jmod = (JL.BatchNorm() if jax_bn == "flax"
            else JL.RawBatchNorm(features=c))
    with jax.enable_x64(True):
        def nhwc(x):
            return jnp.asarray(x.transpose(0, 2, 3, 1))

        kw = ({"use_running_average": False} if jax_bn == "flax"
              else {"train": True})
        variables = jmod.init(jax.random.PRNGKey(0), nhwc(xs[0]), **kw)
        variables = {"params": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)},
                     "batch_stats": jax.tree.map(
                         lambda a: a.astype(jnp.float64),
                         variables["batch_stats"])}
        want = []
        for x in xs[:2]:
            y, upd = jmod.apply(variables, nhwc(x), mutable=["batch_stats"],
                                **kw)
            variables = {**variables, **upd}
            want.append(np.asarray(y).transpose(0, 3, 1, 2))
        kw = ({"use_running_average": True} if jax_bn == "flax"
              else {"train": False})
        want.append(np.asarray(jmod.apply(variables, nhwc(xs[2]), **kw))
                    .transpose(0, 3, 1, 2))
    bn = TL.BatchNorm(c).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        got = [bn.train()(torch.from_numpy(x)) for x in xs[:2]]
        got.append(bn.eval()(torch.from_numpy(xs[2])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]),
                               rtol=1e-12)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]),
                               rtol=1e-12)
    assert bn.num_batches_tracked.item() == 2


def test_batchnorm_keeps_torch_keys_and_cumulative_average(rng):
    """The state_dict keys are BatchNorm2d's; with ``momentum=None`` (what
    calibrate_random_weights sets) training is torch's own: one pass
    leaves that pass's mean and unbiased variance."""
    bn = TL.BatchNorm(4)
    assert isinstance(bn, torch.nn.BatchNorm2d)
    assert sorted(bn.state_dict()) == sorted(
        torch.nn.BatchNorm2d(4).state_dict())
    x = torch.from_numpy(rng.randn(3, 4, 5, 5).astype(np.float32))
    bn.momentum = None
    with torch.no_grad():
        bn.train()(x)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               x.mean(dim=(0, 2, 3)).numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               x.var(dim=(0, 2, 3), unbiased=True).numpy(),
                               rtol=1e-5)


# -- the train step against JAX's ---------------------------------------------

class _PoolStack(nn.Module):
    """Two conv-BatchNorm-ReLU layers of 64 channels, DIM's pool, a conv."""
    pool: object

    @nn.compact
    def __call__(self, x):
        for j in range(2):
            x = JL.Conv(64, 3, padding=1, name=f"c{j}")(x)
            x = nn.relu(JL.BatchNorm(name=f"b{j}")(
                x, use_running_average=False))
        return JL.Conv(16, 3, padding=1, name="last")(self.pool(x)[0])


def test_reduce_window_pool_keeps_the_eager_gradient():
    """The parity steps' JAX pool (``pool_by_reduce_window``), jitted,
    against the JAX package's own pool run op by op, in f64: the same
    gradient (where the jitted original is wrong on XLA:CPU)."""
    with jax.enable_x64(True):
        x = jnp.asarray(np.random.RandomState(0).randn(5, 16, 16, 4))
        grads = []
        for pool, wrap in ((JI.max_pool_argmax_2x2, lambda f: f),
                           (pool_by_reduce_window, jax.jit)):
            m = _PoolStack(pool)
            v = m.init(jax.random.PRNGKey(0), x, mutable=["params",
                                                          "batch_stats"])
            ct = jnp.asarray(np.random.RandomState(1).randn(5, 8, 8, 16))

            def f(p):
                y, _ = m.apply({"params": p,
                                "batch_stats": v["batch_stats"]}, x,
                               mutable=["batch_stats"])
                return (y * ct).sum()

            grads.append(wrap(jax.grad(f))(v["params"]))
        eager, jitted = grads
        assert float(jnp.abs(eager["c1"]["bias"]).max()) < 1e-10
        for path, want in jax.tree_util.tree_flatten_with_path(eager)[0]:
            got = dict(jax.tree_util.tree_flatten_with_path(jitted)[0])[path]
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-9, atol=1e-11,
                                       err_msg=str(path))


def _clip(seed: int, s: int):
    """a, fg, bg ``[1, S, H, W, .]`` f32 0..255: a soft-edged disc moving
    per frame over noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    a = np.stack([np.clip((18 - np.hypot(yy - 30 - 2 * t, xx - 32 + t))
                          / 6.0, 0, 1) * 255 for t in range(s)])
    fg, bg = (rng.randint(0, 256, (1, s, H, W, 3)).astype(np.float32)
              for _ in range(2))
    return {"a": a[None, ..., None].astype(np.float32), "fg": fg, "bg": bg}


def jax_radius(key, b):
    """The radius JAX's forward drivers draw from ``key`` (a copy)."""
    kp, _ = jax.random.split(key)
    return np.array(jax.random.randint(kp, (b,), 0, 26))


class WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``: patched into the
    JAX modules, it widens their f32 islands so that an x64 step is f64
    throughout."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_f64(*modules):
    """x64 on, ``jnp`` widened in the JAX modules the steps reach."""
    wide = WideJnp()
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.enable_x64(True))
        for mod in (JL, JFM, JI, JLo) + modules:
            stack.enter_context(mock.patch.object(mod, "jnp", wide))
        yield


def pool_by_reduce_window(x):
    """The JAX package's ``max_pool_argmax_2x2`` (NHWC) with the max taken
    by ``lax.reduce_window``: the same values and indices. The original
    takes it by ``jnp.max`` over a reshape, and XLA:CPU compiles that
    max's gradient wrongly under ``jit`` after two conv-BatchNorm-ReLU
    layers of 64 channels or more: the conv before the pool gets a bias
    gradient where the exact one is 0, and the kernels below are 45 % off
    (f32 and f64 alike; op by op it is right). The parity steps run the
    JAX side with this pool, and
    ``test_reduce_window_pool_keeps_the_eager_gradient`` holds it against
    the original run op by op."""
    _, idx = JI.max_pool_argmax_2x2(x)
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "VALID"), idx


def _no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: Dropout as the identity."""
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def jax_train_grads(jmod, variables, batch, cfg, driver: str, dtype):
    """JAX's train-step gradient (tcvom_tpu/train/trainer.py:160-170):
    (losses, the gradients as the port's state_dict, the new mutable
    state as the port's state_dict), in ``dtype``."""
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a), dtype),
                          variables["params"])
    state = {k: jax.tree.map(lambda a: jnp.asarray(np.array(a), dtype), v)
             for k, v in variables.items() if k != "params"}
    fwd, weights = ((JFM.forward_vmd, JT.LOSS_WEIGHTS_VMD) if driver == "vmd"
                    else (JFM.forward_single, JT.LOSS_WEIGHTS_SINGLE))

    def loss_fn(p):
        losses, _, new_state = fwd(jmod, {"params": p, **state}, KEY,
                                   {k: jnp.asarray(v, dtype)
                                    for k, v in batch.items()}, cfg,
                                   train=True, mutable=list(state))
        return sum(weights[k] * v for k, v in losses.items()), (losses,
                                                                new_state)

    with nn.intercept_methods(_no_dropout), mock.patch.object(
            JD, "max_pool_argmax_2x2", pool_by_reduce_window):
        (_, (losses, new_state)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    name = cfg.model

    def port(tree):
        return {k: v.double().numpy() for k, v in jax_to_torch_state_dict(
            name, tree).items()}

    return ({k: float(v) for k, v in losses.items()},
            port({"params": grads}), port(dict(new_state)))


def port_train_step(trainer, weights, batch, radius, dtype):
    """One ``MattingTrainer.train_step`` from ``weights``, Dropout in eval:
    (metrics, gradients, buffers after the step, buffers before)."""
    state = trainer.init_state()
    state.model.load_state_dict(weights)
    state.model.to(dtype)
    for m in state.model.modules():
        if isinstance(m, TL.Dropout):
            m.eval()
    before = {k: v.double().clone() for k, v in
              state.model.state_dict().items()}
    state, metrics = trainer.train_step(
        state, {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()},
        radius=torch.from_numpy(radius))
    grads = {n: None if p.grad is None else p.grad.double().numpy()
             for n, p in state.model.named_parameters()}
    after = {k: v.double() for k, v in state.model.state_dict().items()}
    return metrics, grads, after, before


def _zeros_like_init(jmod, *args):
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, *args, train=False))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def step_pair(name, driver, s, prepare, freeze=False, f32=True,
              jax_modules=()):
    """The same train step on both sides, in f32 (if ``f32``) and f64:
    ``{dtype: (port (metrics, grads, after, before), JAX (losses, grads,
    new state))}``, and with ``f32`` the port's step in f64 at the f32
    step's radius under ``"f64 at the f32 radius"`` (x64 JAX draws
    another radius). ``prepare(model, cfg)`` readies the port's random
    weights before they are carried to JAX."""
    port = build_model(name, agg_window=WINDOW, device="cpu",
                       freeze_backbone=freeze)
    cfg = TFM.TaskConfig(model=name, agg_window=WINDOW,
                         freeze_backbone=freeze)
    prepare(port, cfg)
    jmod = JR.build_model(name, agg_window=WINDOW, freeze_backbone=freeze)
    cin = 3 + cfg.trimap_channels
    variables = carried(name, _zeros_like_init(
        jmod, jnp.zeros((1, 3, H, W, cin)), jnp.ones((1, 3, H, W, 1))), port)
    weights = port.state_dict()
    batch = _clip(5, s)
    jcfg = JFM.TaskConfig(model=name, agg_window=WINDOW,
                          freeze_backbone=freeze)
    trainer = TT.MattingTrainer(cfg, driver, device="cpu")
    out = {}
    if f32:
        radius = jax_radius(KEY, 1)
        out[torch.float32] = (
            port_train_step(trainer, weights, batch, radius, torch.float32),
            jax_train_grads(jmod, variables, batch, jcfg, driver,
                            jnp.float32))
        out["f64 at the f32 radius"] = port_train_step(
            trainer, weights, batch, radius, torch.float64)
    with jax_f64(*jax_modules):
        want = jax_train_grads(jmod, variables, batch, jcfg, driver,
                               jnp.float64)
        radius = jax_radius(KEY, 1)
    out[torch.float64] = (port_train_step(trainer, weights, batch, radius,
                                          torch.float64), want)
    return out


def _calibrate(port, cfg):
    imgs, tris = (torch.from_numpy(a) for a in _frames(11))
    calibrate_random_weights(port, lambda: TFM.forward_eval(port, imgs, tris,
                                                            cfg))
    randomize_batchnorms(port, 12)


@pytest.fixture(scope="module")
def steps():
    return "vmn_index", step_pair("vmn_index", "vmd", S, _calibrate)


def module_errors(got: dict, want: dict, prefixes=("",)) -> dict:
    """Relative L2 error of each module's gradient (its parameters'
    gradients as one vector), for the modules under ``prefixes``. A
    parameter's own error is no measure where its exact gradient is 0: a
    conv bias right before a training-mode BatchNorm, or any bias whose
    per-channel constant a later one removes, holds rounding alone (1e-19
    in f64, on both sides)."""
    mods = {}
    for n in want:
        if n.startswith(prefixes):
            mods.setdefault(n.rsplit(".", 1)[0], []).append(n)
    out = {}
    for m, names in mods.items():
        g = np.concatenate([got[n].ravel() for n in names])
        w = np.concatenate([want[n].ravel() for n in names])
        out[m] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300)
    return out


# f32 losses: DIM's argmax pools decide a near-tie by f32 rounding, which
# differs between the frameworks (and with the number of threads) and moves
# a matte pixel, so its losses are held at 1e-3 in f32 (a flip was seen to
# move L1 by 2.4e-4) and at 1e-10 in f64, where the pools agree
F32_LOSS_RTOL = {"vmn_dim": 1e-3, "vmn_index": 1e-4}


def test_train_step_losses_match_jax(steps):
    name, out = steps
    for dtype, rtol in ((torch.float32, F32_LOSS_RTOL[name]),
                        (torch.float64, 1e-10)):
        (metrics, _, _, _), (want, _, _) = out[dtype]
        assert set(want) <= set(metrics)
        for k, v in want.items():
            assert k == "L_dt" or v > 0, k
            np.testing.assert_allclose(metrics[k].item(), v, rtol=rtol,
                                       err_msg=(k, dtype))


def f32_errors(out) -> tuple[dict, dict, dict]:
    """The decoder's and the FAM's f32 gradients by module: (the port's
    against JAX's, the port's against the port's f64 step at the same
    radius, JAX's against that f64 step)."""
    (_, got32, _, _), (_, want32, _) = out[torch.float32]
    _, exact, _, _ = out["f64 at the f32 radius"]
    dec = ("decoder.",)
    return (module_errors(got32, want32, dec),
            module_errors(got32, exact, dec),
            module_errors(want32, exact, dec))


def test_train_step_gradients_match_jax(steps):
    """Relative L2 of each module's gradient (``module_errors``): every
    one within 1e-6 in f64. In f32 the decoder's and the FAM's within
    1e-3 of JAX's, or, where they are not, every one of the port's within
    1e-3 of the f64 step at the same radius and no further from it than
    JAX's f32 step is (median module, 10 % margin): here it is JAX's f32
    step that moves (for DIM ~5e-2 from f64, the port's worst 1.0e-4;
    IndexNet ~8e-4 against 2.2e-5; ``_report`` prints them). The
    encoder's f32 gradients are held in f64 only, as FBA's
    (test_torch_train.py)."""
    _, out = steps
    (_, got64, _, _), (_, want64, _) = out[torch.float64]
    assert sorted(got64) == sorted(want64)
    errs = module_errors(got64, want64)
    assert max(errs.values()) <= 1e-6, max(errs.items(), key=lambda e: e[1])
    errs, port_err, jax_err = f32_errors(out)
    assert any(m.startswith("decoder.fam.") for m in errs)
    if max(errs.values()) > 1e-3:
        assert max(port_err.values()) <= 1e-3, max(port_err.items(),
                                                   key=lambda e: e[1])
        port_med = np.median(list(port_err.values()))
        jax_med = np.median(list(jax_err.values()))
        assert port_med <= 1.1 * jax_med, (max(errs.values()), port_med,
                                           jax_med)


def test_train_step_batchnorm_statistics_match_jax(steps):
    """Every BatchNorm's running mean and variance after the step, in f64,
    against JAX's new batch_stats (rtol 1e-6); every one moved; for
    IndexNet the ASPP pooled branch by name, where torch's own unbiased
    update would be 3/2 off."""
    name, out = steps
    (_, _, after, before), (_, _, new_state) = out[torch.float64]
    keys = [k for k in new_state if k.endswith(("running_mean",
                                                "running_var"))]
    assert keys and len(keys) == len(new_state)
    for k in keys:
        np.testing.assert_allclose(after[k].numpy(), new_state[k], rtol=1e-6,
                                   atol=1e-12, err_msg=k)
        assert not torch.equal(after[k], before[k]), k
    if name == "vmn_index":
        k = POOLED_BN + ".running_var"
        old, new = before[k].numpy(), new_state[k]
        batch_var = (new - 0.9 * old) / 0.1
        unbiased = 0.9 * old + 0.1 * batch_var * S / (S - 1)
        assert not np.allclose(unbiased, new, rtol=1e-3)


# -- dropout ---------------------------------------------------------------

def test_index_dropout_is_live_and_seeded(rng):
    """In a train step IndexNet's Dropout(0.5) zeroes about half of what
    reaches it and doubles the rest, and the masks repeat from the
    trainer's seed (another seed, other masks)."""
    cfg = TFM.TaskConfig(model="index")
    trainer = TT.MattingTrainer(cfg, "single", device="cpu")
    batch = {k: torch.from_numpy(v[:, :3]).repeat(8, 1, 1, 1, 1)
             for k, v in _clip(3, 3).items()}

    def masks(seed):
        state = trainer.init_state(torch.Generator().manual_seed(seed))
        seen = []
        hook = state.model.encoder.dconv_pp.dropout.register_forward_hook(
            lambda m, inp, out: seen.append((inp[0].detach(),
                                             out.detach())))
        trainer.train_step(state, batch, radius=torch.arange(8))
        hook.remove()
        (x, y), = seen
        live = x != 0
        kept = y[live] != 0
        np.testing.assert_allclose(y[live][kept].numpy(),
                                   2 * x[live][kept].numpy(), rtol=1e-6)
        return kept

    first = masks(4)
    assert first.numel() > 1000 and abs(first.float().mean() - 0.5) < 0.05
    assert torch.equal(first, masks(4))
    assert not torch.equal(first, masks(5))


def test_index_single_frame_batch_of_one_raises():
    trainer = TT.MattingTrainer(TFM.TaskConfig(model="index"), "single",
                                device="cpu")
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v[:, :3]) for k, v in _clip(3, 3).items()}
    with pytest.raises(ValueError, match="ASPP pools to 1x1"):
        trainer.train_step(state, batch, radius=torch.tensor([3]))


# -- the frozen backbone ---------------------------------------------------

def _init_args(name):
    cin = 3 + JFM.TaskConfig(model=name).trimap_channels
    fba = name.endswith("fba")
    if name.startswith("vmn_"):
        extras = ((jnp.zeros((1, 3, H, W, 3)), jnp.zeros((1, 3, H, W, 2)))
                  if fba else None)
        return (jnp.zeros((1, 3, H, W, cin)), jnp.ones((1, 3, H, W, 1))), {
            "extras": extras}
    extras = ((jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 2)))
              if fba else None)
    return (jnp.zeros((1, H, W, cin)),), {"extras": extras}


@pytest.mark.parametrize("name", ["fba", "dim", "index", "gca", "vmn_fba",
                                  "vmn_dim", "vmn_index", "vmn_gca"])
def test_trainable_mask_matches_jax(name):
    """The parameters FREEZE_BACKBONE keeps out of the optimizer, against
    JAX's trainable_mask carried through the converter: the encoder and
    the decoder's extract half of each backbone."""
    jmod = JR.build_model(name)
    args, kw = _init_args(name)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, *args, train=False, **kw))
    params = shapes["params"]
    mask = JT.trainable_mask(params, name, True)
    flags = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32),
                         params, mask)
    conv = "vmn_fba" if name == "fba" else name
    want_frozen = {n for n, t in jax_to_torch_state_dict(
        conv, {"params": flags}).items() if not t.any()}
    model = build_model(name, device="cpu")
    got = TT.trainable_mask(model, True)
    assert {n for n, keep in got.items() if not keep} == want_frozen
    assert want_frozen and len(want_frozen) < len(got)
    assert all(TT.trainable_mask(model, False).values())


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_dim", "vmn_index",
                                  "vmn_gca"])
def test_vmn_train_keeps_the_frozen_backbone_in_eval(name):
    """Under freeze_backbone, ``.train()`` leaves the encoder and the
    decoder's extract half in eval mode (every submodule) and the rest in
    training mode; without it everything trains."""
    for freeze in (True, False):
        model = build_model(name, agg_window=WINDOW, device="cpu",
                            layers=(1, 1, 1, 1), freeze_backbone=freeze)
        model.eval().train()
        frozen = {id(m) for part in model.frozen_modules()
                  for m in part.modules()}
        for m in model.modules():
            assert m.training == (not freeze or id(m) not in frozen)
        assert model.training and model.fam.training


def _report():
    """Print what the assertions above hold, as numbers: the XLA:CPU pool
    gradient (the jitted original against the eager one), and for each
    backbone the f64 gradient error and the f32 errors of
    ``f32_errors``."""
    with jax.enable_x64(True):
        x = jnp.asarray(np.random.RandomState(0).randn(5, 16, 16, 4))
        m = _PoolStack(JI.max_pool_argmax_2x2)
        v = m.init(jax.random.PRNGKey(0), x, mutable=["params",
                                                      "batch_stats"])
        ct = jnp.asarray(np.random.RandomState(1).randn(5, 8, 8, 16))

        def f(p):
            y, _ = m.apply({"params": p, "batch_stats": v["batch_stats"]},
                           x, mutable=["batch_stats"])
            return (y * ct).sum()

        eager, jitted = jax.grad(f)(v["params"]), jax.jit(jax.grad(f))(
            v["params"])
        kern = np.linalg.norm(jitted["c0"]["kernel"] - eager["c0"]["kernel"])
        print(f"pool stack, f64: conv c1 bias gradient jitted "
              f"{float(jnp.linalg.norm(jitted['c1']['bias'])):.3g}, eager "
              f"{float(jnp.linalg.norm(eager['c1']['bias'])):.3g}; c0 "
              f"kernel jitted against eager "
              f"{kern / np.linalg.norm(eager['c0']['kernel']):.3g}")
    for name in ("vmn_dim", "vmn_index"):
        out = step_pair(name, "vmd", S, _calibrate)
        (_, got64, _, _), (_, want64, _) = out[torch.float64]
        print(f"{name} f64, every module: worst "
              f"{max(module_errors(got64, want64).values()):.3g}")
        for what, errs in zip(("port-JAX", "port-f64", "JAX-f64"),
                              f32_errors(out)):
            vals = list(errs.values())
            print(f"{name} f32 decoder {what}: worst {max(vals):.3g}, "
                  f"median {np.median(vals):.3g}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_bn.py
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    _report()
