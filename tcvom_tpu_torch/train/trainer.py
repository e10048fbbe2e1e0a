"""Training driver (port of tcvom_tpu/train/trainer.py): the optimizers,
the poly/const schedules, the frozen-backbone parameter filter and the
train, eval, validation and visualization steps on one device.

Loss mixes:
- video (train_ddp.py:61):   L1 + L2 + L3 + 0.5*L_dt + 0.25*L_att
- single (train_single_ddp.py:66, pretrain_ddp.py:65): L1 + L2 + L3
"""
from __future__ import annotations

import dataclasses

import torch

from tcvom_tpu_torch.models import full_model as FM
from tcvom_tpu_torch.models import registry
from tcvom_tpu_torch.ops.losses import l1_mask
from tcvom_tpu_torch.utils.device import resolve_device

# Decoder submodules of the feature-extraction half, frozen with the
# encoder under FREEZE_BACKBONE (the reference sets them to eval() and keeps
# them out of the optimizer: VMN_FBA.py); the JAX package's ppm, up1_0, up1_1
_FROZEN_DECODER_PREFIXES = {"fba": ("ppm.", "conv_up1.")}

LOSS_WEIGHTS_VMD = {"L1": 1.0, "L2": 1.0, "L3": 1.0, "L_dt": 0.5, "L_att": 0.25}
LOSS_WEIGHTS_SINGLE = {"L1": 1.0, "L2": 1.0, "L3": 1.0}


def trainable_mask(model: torch.nn.Module, model_name: str,
                   freeze_backbone: bool) -> dict[str, bool]:
    """Parameter name -> whether the optimizer updates it (the reference's
    requires_grad filtering, train_ddp.py:285-291)."""
    frozen_dec = _FROZEN_DECODER_PREFIXES.get(
        registry.method_of(model_name), ())

    def decide(name: str) -> bool:
        if not freeze_backbone:
            return True
        if name.startswith("encoder."):
            return False
        sub = name.removeprefix("decoder.")
        return sub == name or not sub.startswith(frozen_dec)

    return {n: decide(n) for n, _ in model.named_parameters()}


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
    optimizer and the generator of the random trimap radii."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


class MattingTrainer:
    """Builds the model and optimizer and runs the steps on one device
    (the card unless ``device='cpu'``).

    ``driver``: 'vmd' (FullModel_VMD, the video loss stack) or 'single'
    (FullModel's VMN branch, the TAM pretrain). ``layers`` cuts the
    encoder's depth (widths stay the published ones).

    Every step takes an optional ``radius`` ``[B]``, the per-sample trimap
    dilation; without one it is drawn from ``state.generator``.
    """

    def __init__(self, task_cfg: FM.TaskConfig, driver: str,
                 optimizer: str = "adam", lr_strategy: str = "const",
                 base_lr: float = 5e-4, weight_decay: float = 1e-4,
                 total_iters: int = 100_000, layers=(3, 4, 6, 3),
                 device: str | torch.device = "cuda"):
        if driver not in ("vmd", "single"):
            raise ValueError(driver)
        self.cfg = task_cfg
        self.device = resolve_device(device)
        self.layers = tuple(layers)
        self.lr_schedule = make_lr_schedule(lr_strategy, base_lr, total_iters)
        self._opt_name = optimizer
        self._weight_decay = weight_decay
        self.loss_weights = (LOSS_WEIGHTS_VMD if driver == "vmd"
                             else LOSS_WEIGHTS_SINGLE)
        self._forward = (FM.forward_vmd if driver == "vmd"
                         else FM.forward_single)

    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Random weights from ``generator`` (seed 0 if None), which then
        draws the trimap radii; the optimizer holds only the trainable
        parameters (frozen ones get no update and no weight decay)."""
        gen = generator or torch.Generator().manual_seed(0)
        cfg = self.cfg
        model = registry.build_model(
            cfg.model, agg_window=cfg.agg_window,
            agg_reduction=cfg.agg_reduction, layers=self.layers,
            device=self.device, generator=gen,
            freeze_backbone=cfg.freeze_backbone)
        mask = trainable_mask(model, cfg.model, cfg.freeze_backbone)
        params = [p for n, p in model.named_parameters() if mask[n]]
        return TrainState(step=0, model=model, generator=gen,
                          optimizer=make_optimizer(self._opt_name, params,
                                                   self._weight_decay))

    def _radius(self, state: TrainState, batch: dict, radius):
        if radius is None and self.cfg.dilate_radius is None:
            radius = FM.draw_radius(batch["a"].shape[0], state.generator)
        return radius

    def train_step(self, state: TrainState, batch: dict, radius=None):
        """One optimizer step on ``batch`` (a, fg, bg ``[B, S, H, W, .]``,
        0..255, on the device). Updates ``state`` in place and returns
        (state, metrics): loss, each loss term and the step's lr, as
        0-d device tensors (lr a float). The gradients stay in ``.grad``."""
        model, opt = state.model, state.optimizer
        model.train()
        radius = self._radius(state, batch, radius)
        opt.zero_grad(set_to_none=True)
        losses, _ = self._forward(model, batch, self.cfg, radius)
        total = sum(self.loss_weights[k] * v for k, v in losses.items())
        total.backward()
        lr = self.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in losses.items()}, "lr": lr}
        return state, metrics

    @torch.no_grad()
    def _eval_forward(self, state: TrainState, batch: dict, radius):
        state.model.eval()
        return self._forward(state.model, batch, self.cfg,
                             self._radius(state, batch, radius))

    def eval_step(self, state: TrainState, batch: dict, radius=None):
        """Losses without an update: ({loss, terms}, alphas)."""
        losses, aux = self._eval_forward(state, batch, radius)
        total = sum(self.loss_weights[k] * v for k, v in losses.items())
        return {"loss": total, **losses}, aux["alphas"]

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
        Returns (value, (center alpha, trimap visual, center gt))."""
        _, aux = self._eval_forward(state, batch, radius)
        alphas = torch.round(aux["alphas"] * 255.0) / 255.0
        gts = aux["pre"]["scaled_gts"]
        tm = aux["pre"]["trimasks"]
        s = alphas.shape[1]
        c = s // 2
        terms = [l1_mask(alphas[:, c] - alphas[:, c + d],
                         gts[:, c] - gts[:, c + d], tm[:, c])
                 for d in (-1, 1) if 0 <= c + d < s]
        tris_vis = torch.where(tm[:, c] > 0.5, 128.0 / 255.0, gts[:, c])
        return sum(terms) / len(terms), (alphas[:, c], tris_vis, gts[:, c])
