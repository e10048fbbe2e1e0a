"""Training driver (port of tcvom_tpu/train/trainer.py): the optimizers,
the poly/const schedules, the frozen-backbone parameter filter and the
train, eval, validation and visualization steps, for all eight models, on
one device or data-parallel over the ranks of a process group.

One train step updates, besides the parameters, every BatchNorm's running
statistics and every spectral-norm conv's ``u`` and ``v`` that run in
training mode (the JAX package's ``mutable=list(model_state)``,
tcvom_tpu/train/trainer.py:160-170); a frozen backbone keeps its own.

``compute_dtype=torch.bfloat16`` is the JAX package's bf16 recipe
(``TRAIN.BF16``, tcvom_tpu/train/trainer.py:102-112, :158-199): inside a
train step the floating parameters and the batch are cast to bf16, the
master parameters, Adam's moments and the buffers stay f32. The layers
cast each weight up to its input's dtype (``models/layers.py``), and
``preprocess`` promotes the network's input to f32 (the f32 mean and
std), so the network computes in f32 on bf16-rounded weights, its
gradients rounded to bf16 by the casts' backward; bf16 arithmetic is
left in the data synthesis, the loss targets (FBA's Laplacian pyramid)
and GCA's power iterations, as in JAX. No loss scaling. The other steps
stay f32.

``remat=True`` recomputes the VMN encoder in the backward pass
(``models/vmn.py``, the JAX tool's ``--remat``): the same step, with
less kept from the forward for the backward pass.

Loss mixes:
- video (train_ddp.py:61):   L1 + L2 + L3 + 0.5*L_dt + 0.25*L_att
- single (train_single_ddp.py:66, pretrain_ddp.py:65): L1 + L2 + L3
"""
from __future__ import annotations

import dataclasses

import torch

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models import full_model as FM
from tcvom_tpu_torch.models import registry
from tcvom_tpu_torch.models.layers import Dropout
from tcvom_tpu_torch.ops.losses import l1_mask
from tcvom_tpu_torch.utils.device import resolve_device

LOSS_WEIGHTS_VMD = {"L1": 1.0, "L2": 1.0, "L3": 1.0, "L_dt": 0.5, "L_att": 0.25}
LOSS_WEIGHTS_SINGLE = {"L1": 1.0, "L2": 1.0, "L3": 1.0}


def trainable_mask(model: torch.nn.Module,
                   freeze_backbone: bool) -> dict[str, bool]:
    """Parameter name -> whether the optimizer updates it (the reference's
    requires_grad filtering, train_ddp.py:285-291, VMN_DIM.py:102-108):
    under ``freeze_backbone`` not those of ``model.frozen_modules()``, the
    encoder and the decoder's extract half."""
    frozen = ({id(p) for m in model.frozen_modules() for p in m.parameters()}
              if freeze_backbone else set())
    return {n: id(p) not in frozen for n, p in model.named_parameters()}


def make_lr_schedule(strategy: str, base_lr: float, total_iters: int):
    """Step -> learning rate: 'poly' (``base_lr * (1 - t/T)^0.9``, 0 from
    T on) or 'const' (reference utils/utils.py:185-202)."""
    if strategy == "poly":
        return lambda step: base_lr * (
            1.0 - min(step, total_iters) / total_iters) ** 0.9
    if strategy == "const":
        return lambda step: base_lr
    raise ValueError(strategy)


def make_optimizer(name: str, params, weight_decay: float
                   ) -> torch.optim.Optimizer:
    """adam (L2 added to the gradient before the moments, as torch's Adam
    does), adamw (decoupled decay) or sgd (OPT_DICT, utils/utils.py:193-197).
    The learning rate is set from the schedule before every step."""
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, weight_decay=weight_decay)
    raise ValueError(name)


@dataclasses.dataclass
class TrainState:
    """What a step reads and advances: the step count, the model, its
    optimizer, the generator of the random trimap radii (on the CPU) and,
    for a model with dropout (IndexNet), the dropout masks' generator on
    the model's device, seeded from the first."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    dropout_generator: torch.Generator | None = None
    # the model in DistributedDataParallel, which a data-parallel trainer's
    # train steps run through (made at the first: parallel.wrap); ``model``
    # is what is saved and restored
    ddp: torch.nn.Module | None = None



class MattingTrainer:
    """Builds the model and optimizer and runs the steps on one device
    (the card unless ``device='cpu'``).

    ``driver``: 'vmd' (FullModel_VMD, the video loss stack) or 'single'
    (FullModel: a single-frame model, or a VMN in the TAM pretrain).
    ``layers`` cuts FBA's encoder depth (widths stay the published ones;
    the other backbones have no depth knob). ``remat`` and
    ``compute_dtype``: see the module docstring.

    A trainer made in a process group (``parallel.init_from_env``, of any
    size) trains data-parallel over it, each rank on its own slice of the
    global batch; one made without a group trains in one process. A
    data-parallel train step is then the one-process step on the
    global batch (the JAX package's under GSPMD): DDP averages the
    gradients, BatchNorm reduces over every rank
    (``models/layers.py::BatchNorm``), the losses take their normalizing
    counts over every rank (``global_batch``), the trimap radii and
    IndexNet's dropout masks are drawn for the global batch from
    generators seeded alike on every rank and each rank keeps its rows,
    and the metrics returned are the global batch's. The first train step
    wraps the model (``state.ddp``), after whatever the caller loaded into
    it; a frozen backbone's parameters stop requiring a gradient there.

    Every step takes an optional ``radius``, the per-sample trimap
    dilation of the global batch (``[B * ranks]``);
    without one it is drawn from ``state.generator``.

    ``init_state`` leaves the model in training mode (a frozen backbone in
    eval, ``VMN.train``) and the other steps in eval mode; ``train_step``
    sets training mode when the model as a whole is in eval, and otherwise
    runs it in the modes it is in (a submodule the caller put in eval
    stays there).
    """

    def __init__(self, task_cfg: FM.TaskConfig, driver: str,
                 optimizer: str = "adam", lr_strategy: str = "const",
                 base_lr: float = 5e-4, weight_decay: float = 1e-4,
                 total_iters: int = 100_000, layers=(3, 4, 6, 3),
                 device: str | torch.device = "cuda", remat: bool = False,
                 compute_dtype: torch.dtype | None = None):
        if driver not in ("vmd", "single"):
            raise ValueError(driver)
        self.cfg = task_cfg
        self.device = resolve_device(device)
        self.layers = tuple(layers)
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.lr_schedule = make_lr_schedule(lr_strategy, base_lr, total_iters)
        self._opt_name = optimizer
        self._weight_decay = weight_decay
        self.loss_weights = (LOSS_WEIGHTS_VMD if driver == "vmd"
                             else LOSS_WEIGHTS_SINGLE)
        self._forward = (FM.forward_vmd if driver == "vmd"
                         else FM.forward_single)
        # made in a process group: data-parallel over it
        self._ddp = parallel.is_distributed()
        self._ranks = parallel.world()

    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Random weights from ``generator`` (seed 0 if None), which then
        seeds the dropout generator (IndexNet) and draws the trimap radii;
        the model in training mode; the optimizer holds only the trainable
        parameters (frozen ones get no update and no weight decay)."""
        gen = generator or torch.Generator().manual_seed(0)
        cfg = self.cfg
        model = registry.build_model(
            cfg.model, agg_window=cfg.agg_window,
            agg_reduction=cfg.agg_reduction, layers=self.layers,
            device=self.device, generator=gen,
            freeze_backbone=cfg.freeze_backbone, remat=self.remat).train()
        dropouts = [m for m in model.modules() if isinstance(m, Dropout)]
        drop_gen = None
        if dropouts:
            drop_gen = torch.Generator(device=self.device).manual_seed(
                int(torch.randint(2**62, (), generator=gen)))
            for m in dropouts:
                m.generator = drop_gen
        mask = trainable_mask(model, cfg.freeze_backbone)
        params = [p for n, p in model.named_parameters() if mask[n]]
        return TrainState(step=0, model=model, generator=gen,
                          optimizer=make_optimizer(self._opt_name, params,
                                                   self._weight_decay),
                          dropout_generator=drop_gen)

    def _radius(self, state: TrainState, batch: dict, radius):
        """The rank's rows of the global batch's radii (given, or drawn)."""
        if self.cfg.dilate_radius is not None:
            return radius
        if radius is None:
            radius = FM.draw_radius(batch["a"].shape[0] * self._ranks,
                                    state.generator)
        if self._ranks > 1:
            radius = radius[parallel.shard_slice(len(radius))]
        return radius

    def _net(self, state: TrainState) -> torch.nn.Module:
        """What a train step runs: the model, or in a process group its DDP
        wrapper, made at the first step."""
        if not self._ddp:
            return state.model
        if state.ddp is None:
            mask = trainable_mask(state.model, self.cfg.freeze_backbone)
            for n, p in state.model.named_parameters():
                p.requires_grad_(mask[n])
            state.ddp = parallel.wrap(state.model)
        return state.ddp

    def _in_compute_dtype(self, net: torch.nn.Module):
        """``net`` as a function of its inputs with each floating parameter
        cast to ``compute_dtype`` (JAX's ``_cast_compute``): the cast is
        differentiable, so the gradients reach the f32 parameters through
        it, rounded to bf16 where JAX's cast rounds them. DDP's hooks sit
        on those parameters. The buffers stay as they are: the layers
        round what they read of them and store f32."""
        cd = self.compute_dtype
        params = {n: p.to(cd) if p.is_floating_point() else p
                  for n, p in net.named_parameters()}
        return lambda *args: torch.func.functional_call(net, params, args)

    def _global(self, values: dict) -> dict:
        """The ranks' mean of each 0-d tensor (every rank's share of a
        ``global_batch`` loss averages to the global batch's value)."""
        if self._ranks == 1:
            return values
        mean = parallel.all_reduce_sum(torch.stack(list(values.values()))
                                       ) / self._ranks
        return dict(zip(values, mean.unbind()))

    def train_step(self, state: TrainState, batch: dict, radius=None):
        """One optimizer step on ``batch`` (a, fg, bg ``[B, S, H, W, .]``,
        0..255, on the device). Updates ``state`` in place and returns
        (state, metrics): loss, each loss term and the step's lr, as
        0-d device tensors (lr a float). The gradients stay in ``.grad``.

        IndexNet's ASPP normalizes a 1x1-pooled branch with its batch
        statistics, so its encoder must see more than one frame: a
        single-frame ``index`` step at B = 1 raises ``ValueError`` (the
        frames of every rank count)."""
        opt = state.optimizer
        frames = batch["a"].shape[0] * self._ranks * (
            batch["a"].shape[1] if self.cfg.is_vmn else 1)
        if self.cfg.method == "index" and frames < 2:
            raise ValueError(
                "IndexNet's ASPP pools to 1x1 before a BatchNorm, whose "
                "training statistics need more than one frame: train "
                f"{self.cfg.model!r} at a batch of at least 2 (got B = "
                f"{batch['a'].shape[0]} on {self._ranks} rank(s))")
        net = self._net(state)
        if not state.model.training:
            net.train()
        radius = self._radius(state, batch, radius)
        opt.zero_grad(set_to_none=True)
        run = net
        if self.compute_dtype is not None:
            batch = {k: v.to(self.compute_dtype) for k, v in batch.items()}
            run = self._in_compute_dtype(net)
        losses, _ = self._forward(run, batch, self.cfg, radius,
                                  global_batch=self._ranks > 1)
        total = sum(self.loss_weights[k] * v for k, v in losses.items())
        total.backward()
        lr = self.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        metrics = self._global({"loss": total.detach(),
                                **{k: v.detach() for k, v in losses.items()}})
        return state, {**metrics, "lr": lr}

    @torch.no_grad()
    def _eval_forward(self, state: TrainState, batch: dict, radius):
        state.model.eval()
        return self._forward(state.model, batch, self.cfg,
                             self._radius(state, batch, radius),
                             global_batch=self._ranks > 1)

    def eval_step(self, state: TrainState, batch: dict, radius=None):
        """Losses without an update: ({loss, terms} of the global batch,
        the rank's alphas)."""
        losses, aux = self._eval_forward(state, batch, radius)
        total = sum(self.loss_weights[k] * v for k, v in losses.items())
        return self._global({"loss": total, **losses}), aux["alphas"]

    def vis_step(self, state: TrainState, batch: dict, radius=None) -> dict:
        """The tensors of the periodic image dumps (reference write_image,
        train_ddp.py:27-38, 99-100)."""
        _, aux = self._eval_forward(state, batch, radius)
        pre = aux["pre"]
        return {"pre": {k: pre[k] for k in ("scaled_imgs", "trimasks",
                                             "scaled_gts")},
                "alphas": aux["alphas"], "comps": aux["comps"],
                "Fs": aux["Fs"], "Bs": aux["Bs"]}

    def val_dt_step(self, state: TrainState, batch: dict, radius=None):
        """Validation L_dt on PNG-quantized alphas (the reference's
        /dev/shm PNG round trip, train_ddp.py:102-169): the center frame's
        alpha differences to its neighbours against the ground truth's.
        Returns (value, of the global batch, (the rank's center alpha,
        trimap visual, center gt))."""
        _, aux = self._eval_forward(state, batch, radius)
        alphas = torch.round(aux["alphas"] * 255.0) / 255.0
        gts = aux["pre"]["scaled_gts"]
        tm = aux["pre"]["trimasks"]
        s = alphas.shape[1]
        c = s // 2
        terms = [l1_mask(alphas[:, c] - alphas[:, c + d],
                         gts[:, c] - gts[:, c + d], tm[:, c],
                         global_batch=self._ranks > 1)
                 for d in (-1, 1) if 0 <= c + d < s]
        tris_vis = torch.where(tm[:, c] > 0.5, 128.0 / 255.0, gts[:, c])
        value = self._global({"L_dt": sum(terms) / len(terms)})["L_dt"]
        return value, (alphas[:, c], tris_vis, gts[:, c])
