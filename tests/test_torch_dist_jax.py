"""One data-parallel train step of a BatchNorm model against the JAX
package's, on the CPU, in f64: two ranks over gloo (run as ``python
tests/test_torch_dist_jax.py <folder>``, one process a rank) each take
two clips of a global batch of four and step single-frame IndexNet
(``index``, the ``single`` driver: the center frame of S = 3, 64x64,
SGD) from calibrated weights; JAX's
``MattingTrainer.train_step`` steps the whole batch with the same weights
and trimap radii. The ranks' losses (the global batch's), each module's
update and the BatchNorm running statistics against JAX's. IndexNet's
Dropout is the identity on both sides here (flax's interceptor, the
port's module in eval); ``test_torch_dist_step.py`` holds it live.

JAX's update is taken in f64 (new parameters less old) before the
converter carries it to the port's keys: the converter writes f32, and
the parameters after the step, rounded to f32, would lose the update's
low digits (an update ~1e-5 of its weight keeps ~1e-3 of them)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models import layers as TL
from tcvom_tpu_torch.train import trainer as TT

NAME = "index"
H = W = 64
B = 4
# SGD, so that each parameter's update is its gradient's (plus weight
# decay): Adam's first step, lr * g / (|g| + 1e-8), would hold each
# element's gradient to its own size, which the frameworks' f64 gradients
# (held per module, test_torch_train_bn.py) are not near 0
LR = 0.05


def batch() -> dict:
    """a, fg, bg ``[4, 3, 64, 64, .]`` f32 0..255: soft discs of four
    sizes moving over noise."""
    rng = np.random.RandomState(21)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    a = np.stack([np.stack([np.clip((r - np.hypot(yy - 30 - t, xx - 32))
                                    / (2 + i) + 0.5, 0, 1) * 255
                            for t in range(3)])
                  for i, r in enumerate((10, 14, 18, 22))])
    return {"a": a[..., None].astype(np.float32),
            **{k: rng.randint(0, 256, (B, 3, H, W, 3)).astype(np.float32)
               for k in ("fg", "bg")}}


def _worker(folder: str) -> None:
    """This rank's step from ``folder``'s weights and radii; rank 0 writes
    the losses and the state after the step."""
    torch.set_num_threads(1)
    parallel.init_from_env("cpu", init_method=f"file://{folder}/store")
    trainer = TT.MattingTrainer(TFM.TaskConfig(model=NAME), "single",
                                optimizer="sgd", base_lr=LR, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(torch.load(os.path.join(folder, "w.pth")))
    state.model.double()
    for m in state.model.modules():
        if isinstance(m, TL.Dropout):
            m.eval()
    rows = parallel.shard_slice(B)
    radius = torch.from_numpy(np.load(os.path.join(folder, "radius.npy")))
    _, metrics = trainer.train_step(
        state, {k: torch.from_numpy(v[rows]).double()
                for k, v in batch().items()}, radius=radius)
    if parallel.rank() == 0:
        np.savez(os.path.join(folder, "after.npz"),
                 **{k: v.numpy() for k, v in state.model.state_dict().items()})
        with open(os.path.join(folder, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(the ranks' (losses, state after), JAX's (losses, each parameter's
    update, state after), the state before): the ranks run while JAX
    compiles and steps."""
    import jax
    import jax.numpy as jnp

    from tcvom_tpu.models import full_model as JFM
    from tcvom_tpu.models import registry as JR
    from tcvom_tpu.train import trainer as JT
    from tcvom_tpu.train.state import TrainState
    from tcvom_tpu_torch.models.registry import (build_model,
                                                 calibrate_random_weights)
    from tcvom_tpu_torch.utils.checkpoint import save_weights
    from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict
    from test_torch_dim import _frames, carried, randomize_batchnorms
    from test_torch_dist import run_ranks_started, wait_all
    from test_torch_train_bn import (KEY, _no_dropout, _zeros_like_init,
                                     jax_f64, jax_radius)
    from flax import linen as nn

    folder = tmp_path_factory.mktemp("dist_jax")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = build_model(NAME, device="cpu")
        cfg = TFM.TaskConfig(model=NAME)
        # two clips: the ASPP's pooled BatchNorm needs two frames
        imgs, tris = (torch.from_numpy(np.concatenate(a))
                      for a in zip(_frames(11), _frames(12)))
        calibrate_random_weights(port, lambda: TFM.forward_eval(
            port, imgs, tris, cfg))
        randomize_batchnorms(port, 12)
    finally:
        torch.set_num_threads(threads)
    save_weights(port, str(folder / "w.pth"))
    jmod = JR.build_model(NAME)
    cin = 3 + cfg.trimap_channels
    variables = carried(NAME, _zeros_like_init(jmod, jnp.zeros((1, H, W,
                                                               cin))), port)
    with jax_f64():
        radius = jax_radius(KEY, B)
    np.save(folder / "radius.npy", radius)
    procs = run_ranks_started(os.path.abspath(__file__), [folder])

    jt = JT.MattingTrainer(JFM.TaskConfig(model=NAME), "single",
                           optimizer="sgd", base_lr=LR)
    with jax_f64(), nn.intercept_methods(_no_dropout):
        params = jax.tree.map(lambda a: jnp.asarray(np.array(a),
                                                    jnp.float64),
                              variables["params"])
        model_state = {k: jax.tree.map(
            lambda a: jnp.asarray(np.array(a), jnp.float64), v)
            for k, v in variables.items() if k != "params"}
        jt.tx = JT.make_optimizer("sgd", jt.lr_schedule, 1e-4,
                                  JT.trainable_mask(params, NAME, False))
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           model_state=model_state,
                           opt_state=jt.tx.init(params))
        new, metrics = jt.train_step(
            state, {k: jnp.asarray(v, jnp.float64)
                    for k, v in batch().items()}, KEY)
        update = jax.tree.map(lambda n, o: np.asarray(n)
                              - np.asarray(o, np.float64),
                              new.params, variables["params"])
        want_update, want_state = (
            {k: v.double().numpy() for k, v in
             jax_to_torch_state_dict(NAME, tree).items()}
            for tree in ({"params": update},
                         jax.tree.map(np.asarray, new.variables)))
        want_metrics = {k: float(v) for k, v in metrics.items()}
    before = {k: v.double().numpy() for k, v in port.state_dict().items()}
    wait_all(procs, 600)
    with open(folder / "metrics.json") as f:
        got_metrics = json.load(f)
    got_state = dict(np.load(folder / "after.npz"))
    return ((got_metrics, got_state),
            (want_metrics, want_update, want_state), before)


def update_errors(got: dict, want: dict) -> dict:
    """Each module's update (its parameters' as one vector): relative L2
    of ``got``'s against ``want``'s (both {parameter: update})."""
    mods = {}
    for k in want:
        mods.setdefault(k.rsplit(".", 1)[0], []).append(k)
    out = {}
    for m, names in mods.items():
        g = np.concatenate([got[n].ravel() for n in names])
        w = np.concatenate([want[n].ravel() for n in names])
        out[m] = np.linalg.norm(g - w) / np.linalg.norm(w)
    return out


def test_ddp_losses_match_jax_global_batch(steps):
    (got, _), (want, _, _), _ = steps
    assert want["L1"] > 0
    for k in ("loss", "L1", "L2", "L3", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)


def test_ddp_updated_parameters_match_jax(steps):
    """Each module's SGD update (its gradient plus weight decay) within
    relative L2 1e-6 of JAX's, as the one-process steps' gradients are
    held in f64 (test_torch_train_bn.py)."""
    (_, got), (_, want, _), before = steps
    errs = update_errors({k: got[k] - before[k] for k in want}, want)
    assert len(errs) > 100
    worst = max(errs.items(), key=lambda e: e[1])
    assert worst[1] <= 1e-6, worst


def test_ddp_batchnorm_statistics_match_jax(steps):
    """Every BatchNorm's running mean and variance after the step against
    JAX's global-batch batch_stats (rtol 1e-6, as the one-process steps)."""
    (_, got), (_, _, want), before = steps
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12,
                                   err_msg=k)
        assert not np.array_equal(got[k], before[k]), k


if __name__ == "__main__":
    _worker(sys.argv[1])
