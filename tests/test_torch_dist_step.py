"""Two ranks over gloo on the CPU against one process on their global
batch, in f64 (run as ``python tests/test_torch_dist_step.py <folder>
<part>`` by the fixture, one process a rank, a ``file://`` store in the
folder; the two parts, DIM's models and the rest, at the same time):

- the synchronized ``BatchNorm`` against flax's ``nn.BatchNorm`` through
  the JAX package's layer on the concatenated batch: outputs, the input's
  and the parameters' gradients, running statistics;
- the loss denominators: a single-frame IndexNet step whose two samples'
  unknown regions differ many times over; the DDP step equals the
  one-process step, and the same step with each rank normalizing its own
  batch (the reference's DDP) does not;
- one DDP train step of each of the eight models (B = 1 a rank, S = 3,
  64x64, window 3, random trimap radii, IndexNet's dropout live) against
  the port's one-process step at B = 2: losses, each module's SGD update,
  BatchNorm statistics and spectral-norm ``u``, ``v``. That one-process
  step is held against the JAX package in ``test_torch_train*.py``.

Each DDP step runs in a process group of its own; each rank then leaves
it and runs the one-process step of every other model (so that the
BatchNorms do not synchronize), keeping one model's result at a time
(DIM's f64 weights are 1 GB), and writes the errors for the tests to
hold."""
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models import full_model as FM
from tcvom_tpu_torch.models.layers import BatchNorm
from tcvom_tpu_torch.train.trainer import MattingTrainer

H = W = 64
S = 3
MODELS = ["fba", "vmn_fba", "dim", "vmn_dim", "index", "vmn_index", "gca",
          "vmn_gca"]
# the BatchNorm test's batch: [4, 6, 3, 2] a call, two calls in training
BN_SHAPE = (4, 6, 3, 2)
# f64 throughout: the two sides differ by summation order alone
RTOL = 1e-9


def _soft_clip(seed: int, soft: float) -> dict:
    """a, fg, bg ``[1, S, H, W, .]`` f32 0..255: a disc whose edge ramps
    over ``soft`` pixels, moving per frame, over noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    a = np.stack([np.clip((20 - np.hypot(yy - 30 - 2 * t, xx - 32 + t))
                          / soft + 0.5, 0, 1) * 255 for t in range(S)])
    return {"a": a[None, ..., None].astype(np.float32),
            **{k: rng.randint(0, 256, (1, S, H, W, 3)).astype(np.float32)
               for k in ("fg", "bg")}}


def global_batch(kind: str) -> dict:
    """The global batch of two samples: for ``"steps"`` two soft discs;
    for ``"denominator"`` a disc with a one-pixel edge and one whose edge
    ramps over the whole frame (their unknown regions ~10x apart)."""
    soft = (1.0, 40.0) if kind == "denominator" else (4.0, 9.0)
    clips = [_soft_clip(3 + i, s) for i, s in enumerate(soft)]
    return {k: np.concatenate([c[k] for c in clips]) for k in clips[0]}


def _trainer(name: str, **kw) -> MattingTrainer:
    """SGD (an update linear in the gradient: Adam's first step, lr *
    g / (|g| + 1e-8), would hold gradients that are 0 but for rounding to
    1e-8, and costs DIM's 130 M parameters seconds); data-parallel when
    made in a process group."""
    return MattingTrainer(FM.TaskConfig(model=name, agg_window=3, **kw),
                          "vmd" if name.startswith("vmn") else "single",
                          optimizer="sgd", base_lr=0.1, layers=(1, 1, 1, 1),
                          device="cpu")


def _step(trainer, batch: dict, naive: bool = False,
          evaluate: bool = False):
    """One f64 step from the seed's weights: (metrics, each parameter's
    update, the buffers after); with ``evaluate`` the metrics also hold
    ``eval_step``'s losses on the batch after the step (``eval_<name>``)."""
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state.model.double()
    if naive:
        # each rank normalizing its own batch, as the reference's DDP does
        fwd = trainer._forward
        trainer._forward = lambda *a, global_batch: fwd(*a)
    update = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    batch = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    _, metrics = trainer.train_step(state, batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            update[n].sub_(p).neg_()
    buffers = {k: v.detach().clone() for k, v in
               state.model.named_buffers()}
    if evaluate:
        losses, _ = trainer.eval_step(state, batch)
        metrics.update({f"eval_{k}": float(v) for k, v in losses.items()})
    return metrics, update, buffers


def _rel(a: torch.Tensor, b: torch.Tensor, scale=None) -> float:
    scale = b.norm() if scale is None else scale
    return float((a - b).norm() / scale.clamp_min(1e-300))


def _buffer_scale(state: dict, k: str) -> torch.Tensor:
    """What a buffer's error is relative to: its own norm, and for a
    running mean at least its batch's spread (the running variance's
    root): a mean that is 0 but for rounding has no relative error."""
    scale = state[k].norm()
    if k.endswith("running_mean"):
        var = state[k.removesuffix("mean") + "var"]
        scale = torch.maximum(scale, var.sqrt().norm())
    return scale


def compare(got, want) -> dict:
    """The worst relative errors of ``got`` against ``want`` (``_step``'s
    tuples): each loss, each module's update (its parameters' as one
    vector; with SGD its gradient plus weight decay), each buffer
    (running statistics, ``u``, ``v``; ``_buffer_scale``)."""
    (m1, u1, b1), (m2, u2, b2) = got, want
    mods = {}
    for n in u2:
        mods.setdefault(n.rsplit(".", 1)[0], []).append(n)

    def cat(d, names):
        return torch.cat([d[n].flatten() for n in names])

    def worst(errs):
        return max(errs, key=lambda e: e[0], default=(0.0, None))

    upd = worst((_rel(cat(u1, ns), cat(u2, ns)), m) for m, ns in mods.items())
    bufs = [k for k, v in b2.items() if v.is_floating_point()]
    buf = worst((_rel(b1[k], b2[k], _buffer_scale(b2, k)), k) for k in bufs)
    return {"loss": max(abs(m1[k] - v) / max(abs(v), 1e-300)
                        for k, v in m2.items() if k != "lr" and v),
            "losses": m1, "want_losses": m2, "update": upd[0],
            "update_worst": upd[1], "buffer": buf[0], "buffer_worst": buf[1],
            "buffers": len(bufs), "modules": len(mods),
            "same_keys": sorted(u1) == sorted(u2) and sorted(b1) == sorted(b2)}


# -- the ranks' side ---------------------------------------------------------

def _join(folder: str, tag: str) -> None:
    parallel.init_from_env("cpu", init_method=f"file://{folder}/store_{tag}")


def _bn_ranks(folder: str) -> None:
    """Two training calls and one in eval of the synchronized BatchNorm on
    the rank's rows; its outputs, the gradients of a cotangent's sum and
    the running statistics, to ``bn_<rank>.npz``."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(*BN_SHAPE) * 3 + 1 for _ in range(3)]
    ct = rng.randn(*BN_SHAPE)
    rows = parallel.shard_slice(BN_SHAPE[0])
    bn = BatchNorm(BN_SHAPE[1]).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, BN_SHAPE[1])))
        bn.bias.copy_(torch.from_numpy(rng.randn(BN_SHAPE[1])))
    x = torch.from_numpy(xs[0][rows]).requires_grad_(True)
    y0 = bn.train()(x)
    (y0 * torch.from_numpy(ct[rows])).sum().backward()
    with torch.no_grad():
        y1 = bn(torch.from_numpy(xs[1][rows]))
        y2 = bn.eval()(torch.from_numpy(xs[2][rows]))
    np.savez(os.path.join(folder, f"bn_{parallel.rank()}.npz"),
             y0=y0.detach().numpy(), y1=y1.numpy(), y2=y2.numpy(),
             dx=x.grad.numpy(), dscale=bn.weight.grad.numpy(),
             dbias=bn.bias.grad.numpy(), mean=bn.running_mean.numpy(),
             var=bn.running_var.numpy(),
             tracked=bn.num_batches_tracked.numpy())


def _worker(folder: str, part: str) -> None:
    """Part ``"dim"``: DIM's two models (their 130 M parameters take
    about half of the work); part ``"rest"``: the BatchNorm, the
    denominators and the other six models. The parts run at the same
    time, each on two ranks of its own."""
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    rows = slice(rank, rank + 1)
    out = {}
    if part == "rest":
        _join(folder, "bn")
        _bn_ranks(folder)

        den = global_batch("denominator")
        local = {k: v[rows] for k, v in den.items()}
        got = {"ddp": _step(_trainer("index", dilate_radius=2), local,
                            evaluate=True),
               "naive": _step(_trainer("index", dilate_radius=2), local,
                              naive=True, evaluate=True)}
        tri = FM.make_trimap(torch.from_numpy(local["a"]) / 255.0,
                             FM.TaskConfig(model="index", dilate_radius=2))[1]
        unknown = parallel.all_reduce_sum(torch.zeros(2).index_fill_(
            0, torch.tensor([rank]), float(tri[:, S // 2].sum())))
        dist.destroy_process_group()
        if rank == 0:
            want = _step(_trainer("index", dilate_radius=2), den,
                         evaluate=True)
            out["denominator"] = {k: compare(v, want)
                                  for k, v in got.items()}
            out["denominator"]["unknown"] = unknown.tolist()
        del got

    steps = global_batch("steps")
    # each pair of models: both DDP steps, each in a group of its own; then
    # rank r steps its model of the pair in one process on the global
    # batch, outside any group (so that the BatchNorms do not synchronize),
    # keeping one model's result at a time
    for pair in zip(MODELS[0::2], MODELS[1::2]):
        if (pair[0] == "dim") != (part == "dim"):
            continue
        for name in pair:
            _join(folder, name)
            res = _step(_trainer(name),
                        {k: v[rows] for k, v in steps.items()})
            dist.destroy_process_group()
            if name == pair[rank]:
                kept = res
            del res
        out[pair[rank]] = compare(kept, _step(_trainer(pair[rank]),
                                              steps))
        del kept
    with open(os.path.join(folder, f"errors_{part}_{rank}.json"), "w") as f:
        json.dump(out, f)


# -- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: ({model or "denominator": errors}, folder)."""
    from test_torch_dist import run_ranks_started, wait_all

    folder = tmp_path_factory.mktemp("dist_step")
    parts = ("dim", "rest")
    wait_all([p for part in parts for p in run_ranks_started(
        os.path.abspath(__file__), [folder, part])], 900)
    out = {}
    for part in parts:
        for r in range(2):
            with open(folder / f"errors_{part}_{r}.json") as f:
                out.update(json.load(f))
    return out, folder


def test_synced_batchnorm_matches_flax_on_the_global_batch(ranks):
    """The ranks' rows concatenated against flax's nn.BatchNorm (the JAX
    package's ``BatchNorm``) on the whole batch, f64: both training
    outputs and the eval output, the input's gradient, the parameters'
    gradients summed over the ranks, the running mean and the biased
    running variance, equal on both ranks."""
    import jax
    import jax.numpy as jnp

    from tcvom_tpu.models import layers as JL

    _, folder = ranks
    got = [dict(np.load(folder / f"bn_{r}.npz")) for r in range(2)]
    rng = np.random.RandomState(0)
    xs = [rng.randn(*BN_SHAPE) * 3 + 1 for _ in range(3)]
    ct = rng.randn(*BN_SHAPE)
    scale, bias = rng.uniform(0.5, 1.5, BN_SHAPE[1]), rng.randn(BN_SHAPE[1])

    def nhwc(x):
        return jnp.asarray(x.transpose(0, 2, 3, 1))

    with jax.enable_x64(True):
        mod = JL.BatchNorm()
        stats = mod.init(jax.random.PRNGKey(0), nhwc(xs[0]),
                         use_running_average=False)["batch_stats"]
        stats = jax.tree.map(lambda a: a.astype(jnp.float64), stats)

        def train(p, x, st):
            return mod.apply({"params": p, "batch_stats": st}, x,
                             use_running_average=False,
                             mutable=["batch_stats"])

        params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        (y0, upd), vjp = jax.vjp(lambda p, x: train(p, x, stats), params,
                                 nhwc(xs[0]))
        dp, dx = vjp((nhwc(ct), jax.tree.map(jnp.zeros_like, upd)))
        y1, upd = train(params, nhwc(xs[1]), upd["batch_stats"])
        y2 = mod.apply({"params": params, **upd}, nhwc(xs[2]),
                       use_running_average=True)
    want = {"y0": y0, "y1": y1, "y2": y2, "dx": dx}
    for k, v in want.items():
        np.testing.assert_allclose(
            np.concatenate([g[k] for g in got]),
            np.asarray(v).transpose(0, 3, 1, 2), rtol=1e-10, atol=1e-12,
            err_msg=k)
    for k, jk in (("dscale", "scale"), ("dbias", "bias")):
        np.testing.assert_allclose(got[0][k] + got[1][k],
                                   np.asarray(dp[jk]), rtol=1e-10, err_msg=k)
    for g in got:
        np.testing.assert_allclose(g["mean"], upd["batch_stats"]["mean"],
                                   rtol=1e-12)
        np.testing.assert_allclose(g["var"], upd["batch_stats"]["var"],
                                   rtol=1e-12)
        assert int(g["tracked"]) == 2


def test_loss_denominators_are_the_global_batch(ranks):
    """A single-frame IndexNet step (dilation 2) whose ranks' unknown
    regions are >= 4x apart: the DDP step is the one-process step (losses,
    updates, statistics within 1e-9), and so are the global losses of
    ``eval_step`` after it, while normalizing each rank's losses by its
    own count (the reference's DDP) moves L1 and the updates far past
    that."""
    out, _ = ranks
    den = out["denominator"]
    small, large = sorted(den["unknown"])
    assert small > 0 and large >= 4 * small, den["unknown"]
    ddp, naive = den["ddp"], den["naive"]
    assert ddp["same_keys"]
    assert {"eval_loss", "eval_L1"} <= set(ddp["losses"]), ddp["losses"]
    for k in ("loss", "update", "buffer"):
        assert ddp[k] <= RTOL, (k, ddp)
    assert naive["loss"] > 1e-2 and naive["update"] > 1e-2, naive


@pytest.mark.parametrize("name", MODELS)
def test_ddp_step_is_the_global_batch_step(ranks, name):
    """Two ranks at B = 1 against one process at B = 2, f64: every loss
    within rtol 1e-9, each module's SGD update (its gradient plus weight
    decay) within relative L2 1e-9, every BatchNorm statistic and u, v
    within 1e-9."""
    out, _ = ranks
    err = out[name]
    assert err["same_keys"] and err["modules"] > 10
    assert err["losses"]["L1"] > 0
    for k in ("loss", "update"):
        assert err[k] <= RTOL, (k, err)
    if name.endswith(("dim", "index", "gca")):
        assert err["buffers"] > 10 and err["buffer"] <= RTOL, err


if __name__ == "__main__":
    _worker(*sys.argv[1:])
