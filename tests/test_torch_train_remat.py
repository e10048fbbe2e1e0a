"""``--remat`` (the port's ``build_model(remat=True)``: the VMN encoder
under non-reentrant ``torch.utils.checkpoint``, recomputed in the backward
pass) and the two training options through ``tools.train``, on the CPU:

- for all four VMN models a remat step is bit for bit the plain step,
  twice in a row: losses, gradients, BatchNorm statistics and their
  counts, GCA's ``u`` and ``v``, IndexNet's dropout generator (its live
  mask recomputed from the state the first run kept), and it keeps less
  for the backward pass; a frozen backbone makes it a no-op;
- the ``vmn_gca`` remat step in f64 against JAX's ``build_model(remat=
  True)`` step (TAM-pretrain driver, S = 3);
- two gloo ranks of ``vmn_index`` with remat (the synchronized
  BatchNorm's all-reduces recomputed in the backward pass) against one
  process at the global batch, in f64; one gloo rank's bf16 step against
  the plain bf16 step, bit for bit;
- ``tools.train`` with ``TRAIN.BF16 True --remat`` (a wiring test of the
  port against itself: its logged losses are the trainer's).

Run as ``python tests/test_torch_train_remat.py <folder>`` it is one rank
of the two-rank step (``RANK``, ``WORLD_SIZE`` set; a ``file://`` store
in the folder)."""
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models import layers as TL
from tcvom_tpu_torch.models.registry import converge_spectral_norms
from tcvom_tpu_torch.train.trainer import MattingTrainer
from test_torch_train_bn import one_thread  # noqa: F401

H = W = 64
S = 3
MODELS = ["vmn_fba", "vmn_dim", "vmn_index", "vmn_gca"]


def _batch(b: int, seed: int = 5) -> dict:
    """a, fg, bg ``[B, S, H, W, .]`` f32 0..255: a soft disc moving over
    noise, each sample shifted."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    a = np.stack([np.stack([np.clip(
        (18 - np.hypot(yy - 30 - 2 * t - 3 * i, xx - 32 + t)) / 6.0, 0, 1)
        * 255 for t in range(S)]) for i in range(b)])
    return {"a": torch.from_numpy(a[..., None].astype(np.float32)),
            **{k: torch.from_numpy(rng.randint(0, 256, (b, S, H, W, 3))
                                   .astype(np.float32)) for k in ("fg",
                                                                  "bg")}}


def _trainer(name: str, remat: bool, **kw) -> MattingTrainer:
    return MattingTrainer(TFM.TaskConfig(model=name, agg_window=3,
                                         **kw.pop("task", {})), "vmd",
                          layers=(1, 1, 1, 1), device="cpu", remat=remat,
                          **kw)


def _two_steps(name: str, remat: bool, freeze: bool = False):
    """Two train steps from seed 1's weights (GCA's ``u``, ``v``
    converged): (the metrics of each, the gradients and the state_dict
    after each, the dropout generator's state after, the bytes kept for
    the backward pass by each forward)."""
    trainer = _trainer(name, remat, task={"freeze_backbone": freeze})
    state = trainer.init_state(torch.Generator().manual_seed(1))
    if name == "vmn_gca":
        converge_spectral_norms(state.model)
    b = 2 if name == "vmn_index" else 1
    batch = _batch(b)
    out = []
    for _ in range(2):
        kept = [0]

        def pack(t):
            kept[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _, metrics = trainer.train_step(state, batch,
                                            radius=torch.full((b,), 4))
        grads = {n: p.grad.clone() for n, p in
                 state.model.named_parameters() if p.grad is not None}
        out.append((metrics, grads, {k: v.clone() for k, v in
                                     state.model.state_dict().items()},
                    kept[0]))
    gen = state.dropout_generator
    return out, None if gen is None else gen.get_state()


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(name, plain two steps, remat two steps)."""
    name = request.param
    return name, _two_steps(name, False), _two_steps(name, True)


def test_remat_steps_are_the_plain_steps(pair):
    """Two remat steps end bit for bit where two plain steps end: every
    loss, every gradient, every buffer (BatchNorm statistics and
    ``num_batches_tracked``, which the recomputation does not step again,
    ``u``, ``v``), and IndexNet's dropout generator stands where the
    plain steps leave it."""
    name, (plain, gen_plain), (remat, gen_remat) = pair
    for (m1, g1, s1, _), (m2, g2, s2, _) in zip(plain, remat):
        assert m1 == m2 or all(torch.equal(m1[k], m2[k]) for k in m1
                               if k != "lr")
        assert sorted(g1) == sorted(g2) and g1
        for n in g1:
            assert torch.equal(g1[n], g2[n]), n
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
    tracked = [v for k, v in remat[1][2].items()
               if k.endswith("num_batches_tracked")]
    assert all(int(t) == 2 for t in tracked) and (
        bool(tracked) == (name != "vmn_fba"))
    if name == "vmn_index":
        assert torch.equal(gen_plain, gen_remat)
    else:
        assert gen_plain is None and gen_remat is None


def test_remat_keeps_less_for_the_backward(pair):
    """The remat forward keeps less for the backward pass (the encoder's
    activations are recomputed instead): the bytes through
    ``saved_tensors_hooks``."""
    _, (plain, _), (remat, _) = pair
    assert remat[0][3] < plain[0][3]


def test_recomputed_dropout_draws_the_first_mask():
    """A Dropout with its own generator under ``checkpointed``: the
    recomputed forward draws the first run's mask (the gradient is the
    mask's) and leaves the generator where one forward leaves it."""
    drop = TL.Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(3)
    x = torch.randn(4, 64, requires_grad=True)
    y = TL.checkpointed(drop, x)
    y.sum().backward()
    assert torch.equal(x.grad, (y != 0).float() * 2.0)
    ref = torch.Generator().manual_seed(3)
    torch.empty(4, 64).bernoulli_(0.5, generator=ref)
    assert torch.equal(drop.generator.get_state(), ref.get_state())


def test_frozen_backbone_makes_remat_a_noop(monkeypatch):
    """Under FREEZE_BACKBONE the encoder runs without gradient: no
    checkpoint is made, and the remat step is the plain step
    (``vmn_index``: its frozen encoder, the ASPP's dropout with it, runs
    in eval mode)."""
    made = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: made.append(1) or real(*a, **kw))
    plain, _ = _two_steps("vmn_index", False, freeze=True)
    remat, _ = _two_steps("vmn_index", True, freeze=True)
    assert not made
    for (m1, g1, s1, _), (m2, g2, s2, _) in zip(plain, remat):
        assert all(torch.equal(m1[k], m2[k]) for k in m1 if k != "lr")
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k


# -- against JAX's nn.remat ------------------------------------------------

def test_gca_remat_step_matches_jax_f64():
    """``vmn_gca`` with remat, one TAM-pretrain step (single driver, S =
    3) in f64, against JAX's ``build_model(remat=True)`` step: losses
    (rtol 1e-4, GCA's attention), each module's gradient within relative
    L2 1e-6, every BatchNorm statistic and ``u``, ``v`` within rtol 1e-6
    (the weights of test_torch_train_gca.py)."""
    import jax
    import jax.numpy as jnp

    from tcvom_tpu.models import full_model as JFM
    from tcvom_tpu.models import registry as JR
    from tcvom_tpu.ops import gca_attention as JA
    from tcvom_tpu_torch.models.registry import build_model
    from test_torch_dim import carried
    from test_torch_train_bn import (KEY, _clip, jax_f64, jax_radius,
                                     jax_train_grads, module_errors,
                                     port_train_step)
    from test_torch_train_gca import _prepare

    name = "vmn_gca"
    port = build_model(name, agg_window=3, device="cpu")
    cfg = TFM.TaskConfig(model=name, agg_window=3)
    _prepare(port, cfg)
    jmod = JR.build_model(name, agg_window=3, remat=True)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, H, W, 6)),
        jnp.ones((1, 3, H, W, 1)), train=False))
    variables = carried(name, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), port)
    batch = _clip(5, 3)
    with jax_f64(JA):
        want = jax_train_grads(jmod, variables, batch,
                               JFM.TaskConfig(model=name, agg_window=3),
                               "single", jnp.float64)
        radius = jax_radius(KEY, 1)
    trainer = MattingTrainer(cfg, "single", device="cpu", remat=True)
    got = port_train_step(trainer, port.state_dict(), batch, radius,
                          torch.float64)
    (metrics, grads, after, _), (losses, jgrads, new_state) = got, want
    for k, v in losses.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4,
                                   atol=1e-12, err_msg=k)
    errs = module_errors(grads, jgrads)
    assert len(errs) > 100 and max(errs.values()) <= 1e-6, max(
        errs.items(), key=lambda e: e[1])
    assert new_state
    for k, v in new_state.items():
        np.testing.assert_allclose(after[k].numpy(), v, rtol=1e-6,
                                   atol=1e-12, err_msg=k)


# -- data-parallel ------------------------------------------------------------

def _sgd(remat: bool) -> MattingTrainer:
    """test_torch_dist_step.py's SGD trainer of ``vmn_index``."""
    return _trainer("vmn_index", remat, optimizer="sgd", base_lr=0.1)


def _rank(folder: str) -> None:
    """A rank of the two-rank remat step: its half of the global batch,
    the result to ``rank_<r>.pt``."""
    from test_torch_dist_step import _step, global_batch
    torch.set_num_threads(1)
    parallel.init_from_env("cpu", init_method=f"file://{folder}/store")
    rank = parallel.rank()
    local = {k: v[rank:rank + 1] for k, v in global_batch("steps").items()}
    torch.save(_step(_sgd(True), local), os.path.join(folder,
                                                      f"rank_{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_ddp_remat_step_is_the_one_process_step(tmp_path):
    """Two gloo ranks of ``vmn_index`` with remat, B = 1 each (dropout
    live; the synchronized BatchNorm's all-reduces run again in the
    recomputation, in the backward pass) against the plain one-process
    step at B = 2, in f64: losses, each module's SGD update and every
    buffer within test_torch_dist_step.py's 1e-9, on both ranks."""
    from test_torch_dist import run_ranks
    from test_torch_dist_step import RTOL, _step, compare, global_batch
    run_ranks(os.path.abspath(__file__), [tmp_path], timeout=600)
    want = _step(_sgd(False), global_batch("steps"))
    for r in range(2):
        c = compare(torch.load(tmp_path / f"rank_{r}.pt"), want)
        assert c["same_keys"] and c["modules"] > 50, c
        assert max(c["loss"], c["update"], c["buffer"]) <= RTOL, c


def test_ddp_bf16_step_of_one_rank_is_the_plain_bf16_step(monkeypatch,
                                                          tmp_path):
    """A bf16 trainer made in a gloo group of one rank (DDP's hooks on the
    f32 parameters, the bf16 casts made inside the step) takes two steps
    bit for bit where the plain bf16 trainer's take them (``vmn_index``,
    B = 2, S = 3): losses, gradients, weights and statistics."""
    runs = []
    try:
        for ddp in (False, True):
            if ddp:
                for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"),
                             ("LOCAL_RANK", "0")):
                    monkeypatch.setenv(k, v)
                parallel.init_from_env("cpu",
                                       init_method=f"file://{tmp_path}/pg")
            trainer = _trainer("vmn_index", False,
                               compute_dtype=torch.bfloat16)
            state = trainer.init_state(torch.Generator().manual_seed(1))
            metrics = [trainer.train_step(state, _batch(2),
                                          radius=torch.tensor([2, 5]))[1]
                       for _ in range(2)]
            runs.append((state, metrics))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    (plain, m1), (wrapped, m2) = runs
    assert plain.ddp is None and wrapped.ddp is not None
    for a, b in zip(m1, m2):
        assert all(torch.equal(a[k], b[k]) for k in a if k != "lr")
    sd = wrapped.model.state_dict()
    for k, v in plain.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    grads = dict(wrapped.model.named_parameters())
    for n, p in plain.model.named_parameters():
        assert torch.equal(grads[n].grad, p.grad), n


# -- the tool ----------------------------------------------------------------

def test_train_tool_bf16_remat_logs_the_trainers_losses(tmp_path):
    """``tools.train --device cpu --remat`` with ``TRAIN.BF16 True``, one
    step of ``vmn_index`` (B = 2, S = 5) on a fake tree: it runs the
    trainer with the bf16 recipe and remat, and the losses its log line
    prints are those of a ``MattingTrainer(compute_dtype=torch.bfloat16,
    remat=True)`` step on the batch the tool's loader gave it. A wiring
    test of the port against itself (the recipe and remat are held
    against JAX above and in test_torch_train_bf16.py)."""
    from tcvom_tpu_torch.config import load_config
    from tcvom_tpu_torch.data.loader import make_loader
    from tcvom_tpu_torch.tools import train
    from tcvom_tpu_torch.tools.make_fake_dataset import make

    make(str(tmp_path / "vmd"), frames=4, hw=(72, 96), seed=7)
    argv = ["--cfg", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfgs",
        "vmd_vmn_index_pretrained_30ep.yaml"), "--device", "cpu", "--remat",
        "DATASET.PATH", str(tmp_path / "vmd"), "TRAIN.LOAD_CKPT", "",
        "SYSTEM.OUTDIR", str(tmp_path / "log"), "SYSTEM.NUM_WORKERS", "0",
        "AGG_WINDOW", "3", "TRAIN.BATCH_SIZE_PER_GPU", "2",
        "TRAIN.TRAIN_INPUT_SIZE", "[64, 64]", "TRAIN.TOTAL_STEPS", "1",
        "TRAIN.PRINT_FREQ", "1", "TRAIN.IMAGE_FREQ", "100", "TRAIN.BF16",
        "True"]
    stats = train.main(argv)
    # the same steps, made here as the tool makes them
    args = train.build_argparser().parse_args(argv)
    cfg = load_config(args.cfg, args.opts)
    seed = cfg.SYSTEM.RANDOM_SEED
    loader = make_loader(train._datasets(cfg, args, seed)[0], 2, 0,
                         shuffle=True, seed=seed, drop_last=True)
    loader.sampler.set_epoch(0)
    trainer = MattingTrainer(
        TFM.TaskConfig(model=cfg.MODEL, agg_window=3), "vmd",
        optimizer=cfg.TRAIN.OPTIMIZER, lr_strategy=cfg.TRAIN.LR_STRATEGY,
        base_lr=cfg.TRAIN.BASE_LR, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
        total_iters=len(loader), device="cpu", remat=True,
        compute_dtype=torch.bfloat16)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    want = []
    for i, b in enumerate(loader):
        batch = {k: torch.from_numpy(b[k]) for k in ("a", "fg", "bg")}
        want.append(trainer.train_step(state, batch)[1])
        if i == 0:          # the tool's image dump draws its radii too
            trainer.vis_step(state, batch)
    assert stats["step"] == len(want) == 2
    out = tmp_path / "log" / "vmd_vmn_index_pretrained_30ep_agg7"
    log = next(p for p in os.listdir(out) if p.endswith("_train.log"))
    lines = [ln for ln in open(out / log) if "Current: Loss:" in ln]
    assert len(lines) == 2
    for ln, m in zip(lines, want):
        got = dict(re.findall(r"(\w+): (-?[\d.]+)", ln.split("Current:")[1]))
        assert float(got["Loss"]) == pytest.approx(m["loss"].item(),
                                                   abs=1e-6)
        for name, k in zip(("L_alpha", "L_comp", "L_grad", "L_dt",
                            "L_att"), ("L1", "L2", "L3", "L_dt", "L_att")):
            assert float(got[name]) == pytest.approx(m[k].item(), abs=1e-4)
    with open(out / "train_stats.json") as f:
        assert json.load(f)["steps"] == 2


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank(sys.argv[1])
