"""Task configuration, preprocessing, trimap synthesis, the loss stacks and
the training and evaluation forward passes (port of
tcvom_tpu/models/full_model.py).

Tensors here keep the JAX package's layout: ``[B, H, W, C]`` (eval) or
``[B, S, H, W, C]`` (clips), f32 in [0, 255], BGR. The model itself is
NCHW; :func:`_run_vmn` converts at its boundary.

A bf16 batch (the bf16 training recipe) is synthesized in bf16 as in JAX
(tcvom_tpu/models/full_model.py:59-109): the scales, the composite and
the trimap encodings keep the batch's dtype, 1/255 rounded to it as JAX
rounds a Python float there, except FBA's EDT planes (f32, kernel A);
``imgs`` is promoted to f32 by the f32 mean and std, and so is the
network's input.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models import registry
from tcvom_tpu_torch.models.layers import weak
from tcvom_tpu_torch.ops import losses as L
from tcvom_tpu_torch.ops.distance import trimap_transform
from tcvom_tpu_torch.ops.image import avg_pool, dilate_by_radius, unfold
from tcvom_tpu_torch.parallel import space

IMG_SCALE = 1.0 / 255.0
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)
MAX_RADIUS = 25                    # random trimap dilation radius 0..25


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    model: str                         # e.g. 'vmn_fba'
    agg_window: int = 7
    agg_reduction: int = 1
    freeze_backbone: bool = False
    dilate_radius: int | None = None   # fixed trimap dilation; None = random
    eps: float = 0.0                   # alpha snapping for pretrain (1e-2)
    att_thres: float = 0.3
    label_smooth: float = 0.2
    fba_loss_normalize: bool = True

    @property
    def method(self) -> str:
        return registry.method_of(self.model)

    @property
    def trimap_channels(self) -> int:
        return registry.TRIMAP_CHANNEL_DICT[self.method]

    @property
    def is_vmn(self) -> bool:
        return self.model.startswith("vmn")


def _normalize(scaled_imgs: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMG_MEAN, dtype=torch.float32,
                        device=scaled_imgs.device)
    std = torch.tensor(IMG_STD, dtype=torch.float32, device=scaled_imgs.device)
    return (scaled_imgs - mean) / std


def preprocess_eval(img: torch.Tensor, tri: torch.Tensor,
                    cfg: TaskConfig) -> dict:
    """EvalModel preprocessing from real trimaps (reference
    models/model.py:360-387). ``img`` BGR, ``tri`` a hard trimap whose
    fg/bg pixels are exactly 255/0; both f32 in [0, 255].

    The scale is a multiply by the f32 constant 1/255 (not a divide), so
    that tri = 255 maps to exactly 1.0, as in the JAX package; the 8-channel
    FBA encoding then takes fg/bg by exact equality."""
    scaled_imgs = img.flip(-1) * IMG_SCALE
    imgs = _normalize(scaled_imgs)
    scaled_tris = tri * IMG_SCALE
    trimask = ((scaled_tris > 0) & (scaled_tris < 1)).float()
    if cfg.dilate_radius is not None:
        trimask = dilate_by_radius(trimask, int(cfg.dilate_radius))
    tc = cfg.trimap_channels
    if tc == 1:
        tris = scaled_tris
    elif tc == 3:
        tri1 = torch.where(trimask > 0.5, 1.0, 2.0 * scaled_tris).long()
        tris = F.one_hot(tri1[..., 0], 3).float()
    else:
        t2f = (scaled_tris == 1.0).float()
        t2b = (scaled_tris == 0.0).float()
        tri2 = torch.cat([t2b, t2f], dim=-1)
        tris = torch.cat([trimap_transform(tri2), tri2], dim=-1)
    return dict(scaled_imgs=scaled_imgs, tris=tris, trimasks=trimask,
                imgs=imgs)


# ---------------------------------------------------------------------------
# Training preprocessing (reference models/model.py:54-92)
# ---------------------------------------------------------------------------

def draw_radius(batch: int, generator: torch.Generator | None = None
                ) -> torch.Tensor:
    """Per-sample random trimap dilation radius in [0, MAX_RADIUS]."""
    return torch.randint(0, MAX_RADIUS + 1, (batch,), generator=generator)


def make_trimap(alpha: torch.Tensor, cfg: TaskConfig,
                radius: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """alpha: ``[B, S, H, W, 1]`` in [0, 1]. Returns (trimap encoding
    ``[B, S, H, W, trimap_channels]``, trimask ``[B, S, H, W, 1]``, the
    dilated unknown region). ``radius``: the per-sample dilation ``[B]``
    (see :func:`draw_radius`); unused when ``cfg.dilate_radius`` is set."""
    if cfg.eps > 0:
        alpha = torch.where(alpha < cfg.eps, 0.0, alpha)
        alpha = torch.where(alpha > 1 - cfg.eps, 1.0, alpha)
    trimask = ((alpha > 0) & (alpha < 1.0)).to(alpha.dtype)
    if cfg.dilate_radius is None:
        if radius is None:
            raise ValueError("a random-width trimap needs the per-sample "
                             "radius (draw_radius)")
        trimap = dilate_by_radius(trimask, radius, max_radius=MAX_RADIUS)
    else:
        trimap = dilate_by_radius(trimask, int(cfg.dilate_radius))

    tc = cfg.trimap_channels
    if tc == 1:
        return torch.where(trimap > 0.5, 128.0 * IMG_SCALE, alpha), trimap
    if tc == 3:
        tri1 = torch.where(trimap > 0.5, 1.0, 2.0 * alpha).long()
        return F.one_hot(tri1[..., 0], 3).to(alpha.dtype), trimap
    tri1 = torch.where(trimap > 0.5, 255.0, alpha)
    t2f = (tri1 == 1.0).to(alpha.dtype)
    t2b = (tri1 == 0.0).to(alpha.dtype)
    tri2 = torch.cat([t2b, t2f], dim=-1)
    return torch.cat([trimap_transform(tri2), tri2], dim=-1), trimap


@torch.no_grad()
def preprocess(a, fg, bg, cfg: TaskConfig, radius=None) -> dict:
    """Compose, normalize and synthesize trimaps (models/model.py:82-92),
    without gradient, as the reference's ``torch.no_grad()`` block."""
    scale = weak(IMG_SCALE, a.dtype)
    scaled_gts = a * scale
    scaled_fgs = fg.flip(-1) * scale              # BGR -> RGB
    scaled_bgs = bg.flip(-1) * scale
    scaled_imgs = scaled_fgs * scaled_gts + scaled_bgs * (1.0 - scaled_gts)
    tris, trimasks = make_trimap(scaled_gts, cfg, radius)
    return dict(scaled_imgs=scaled_imgs, scaled_fgs=scaled_fgs,
                scaled_bgs=scaled_bgs, scaled_gts=scaled_gts, tris=tris,
                trimasks=trimasks, imgs=_normalize(scaled_imgs))


# ---------------------------------------------------------------------------
# Losses (reference models/model.py:94-197, 286-345)
#
# ``global_batch=True``: a rank's share of each loss over the batch of every
# rank of the process group (see ops/losses.py): the mean of the ranks'
# values and of their gradients is the loss of the global batch, as the JAX
# package computes it under GSPMD.
# ---------------------------------------------------------------------------

def single_image_losses(cfg: TaskConfig, preds, pre, start: int, end: int,
                        global_batch: bool = False):
    """Per-frame L_alpha, L_comp and L_grad of the non-FBA methods over the
    trimap's unknown region (models/model.py:94-127; GCA has only
    L_alpha): preds ``[B, S, H, W, 1]``. Returns (L1, L2, L3, alphas,
    comps), the last two clipped to [0, 1] with the frames outside
    [start, end) zero."""
    gts, fgs, bgs, imgs = (pre["scaled_gts"], pre["scaled_fgs"],
                           pre["scaled_bgs"], pre["scaled_imgs"])
    tm = pre["trimasks"]
    s = preds.shape[1]
    gca = cfg.method == "gca"
    l_alpha, l_comp, l_grad = [], [], []
    alphas, comps = [None] * s, [None] * s
    for c in range(start, end):
        mask = tm[:, c]
        refine = torch.where(mask > 0.5, preds[:, c], gts[:, c])
        comps[c] = fgs[:, c] * refine + bgs[:, c] * (1.0 - refine)
        alphas[c] = refine
        l_alpha.append(L.l1_mask(refine, gts[:, c], mask,
                                 global_batch=global_batch))
        if not gca:
            l_comp.append(L.l1_mask(comps[c], imgs[:, c], mask,
                                    global_batch=global_batch))
            l_grad.append(L.l1_grad(refine, gts[:, c], mask,
                                    global_batch=global_batch))
    loss_a = sum(l_alpha) / len(l_alpha)
    zero = torch.zeros_like(loss_a)
    for i in range(s):
        if alphas[i] is None:
            alphas[i] = torch.zeros_like(alphas[start])
            comps[i] = torch.zeros_like(comps[start])
    return (loss_a, zero if gca else sum(l_comp) / len(l_comp),
            zero if gca else sum(l_grad) / len(l_grad),
            torch.clamp(torch.stack(alphas, 1), 0, 1),
            torch.clamp(torch.stack(comps, 1), 0, 1))


def fba_single_image_losses(cfg: TaskConfig, preds, pre, start: int,
                            end: int, global_batch: bool = False):
    """FBA composite losses (models/model.py:129-197): preds
    ``[B, S, H, W, 7]``. Returns (L_alpha_comp, L_lap, L_grad, alphas,
    comps, Fs, Bs), the last four ``[B, S, H, W, .]`` with the frames
    outside [start, end) zero."""
    gts, fgs, bgs, imgs = (pre["scaled_gts"], pre["scaled_fgs"],
                           pre["scaled_bgs"], pre["scaled_imgs"])
    tm = pre["trimasks"]
    nrm = cfg.fba_loss_normalize
    s = preds.shape[1]
    alpha_p, f_p, b_p = preds[..., 0:1], preds[..., 1:4], preds[..., 4:7]
    l_ac, l_lap, l_grad = [], [], []
    alphas, comps, fs, bs = [None] * s, [None] * s, [None] * s, [None] * s
    for c in range(start, end):
        mask = tm[:, c] > 0.5
        refine = torch.where(mask, alpha_p[:, c], gts[:, c])
        cf = torch.where(mask, f_p[:, c], fgs[:, c])
        cb = torch.where(mask, b_p[:, c], bgs[:, c])
        alphas[c] = refine
        comps[c] = cf * refine + cb * (1.0 - refine)
        fs[c], bs[c] = cf, cb

        kw = dict(normalize=nrm, global_batch=global_batch)
        l_a1 = L.l1_mask(refine, gts[:, c], **kw)
        ac = cf * gts[:, c] + cb * (1.0 - gts[:, c])
        l_acomp = L.l1_mask(ac, imgs[:, c], **kw)
        fbc = fgs[:, c] * refine + bgs[:, c] * (1.0 - refine)
        l_fbc = L.l1_mask(fbc, imgs[:, c], **kw)
        l_fb1 = (L.l1_mask(cf, fgs[:, c], **kw)
                 + L.l1_mask(cb, bgs[:, c], **kw))
        l_ac.append(l_a1 + l_acomp + 0.25 * (l_fbc + l_fb1))

        l_ag = L.l1_grad(refine, gts[:, c], **kw)
        l_excl = L.exclusion_loss(cf, cb, level=3, **kw)
        l_grad.append(l_ag + 0.25 * l_excl)

        l_alap = L.lap_loss(refine, gts[:, c], **kw)
        l_flap = L.lap_loss(cf, fgs[:, c], **kw)
        l_blap = L.lap_loss(cb, bgs[:, c], **kw)
        l_lap.append(l_alap + 0.25 * (l_flap + l_blap))
    for i in range(s):
        if alphas[i] is None:
            alphas[i] = torch.zeros_like(alphas[start])
            comps[i] = torch.zeros_like(comps[start])
            fs[i] = torch.zeros_like(fs[start])
            bs[i] = torch.zeros_like(bs[start])
    return (sum(l_ac) / len(l_ac), sum(l_lap) / len(l_lap),
            sum(l_grad) / len(l_grad), torch.stack(alphas, 1),
            torch.stack(comps, 1), torch.stack(fs, 1), torch.stack(bs, 1))


def attention_loss(cfg: TaskConfig, attb, attf, small_mask, scaled_gts,
                   tam_os: int = 8, global_batch: bool = False):
    """L_att: BCE supervision of the FAM logits (models/model.py:286-321).
    attb/attf: ``[B, S-2, h, w, window^2]`` raw logits; small_mask
    ``[B, S-2, h, w, 1]``; scaled_gts ``[B, S, H, W, 1]``. Each centre's
    term is normalized by its count of unknown pixels and is 0 where
    there are none (the count over every rank with ``global_batch``)."""
    ranks = parallel.world() if global_batch else 1
    s = scaled_gts.shape[1]
    win = cfg.agg_window
    eps_smooth = 1.0 - cfg.label_smooth
    terms = []
    for c in range(1, s - 1):
        j = c - 1
        cgt = avg_pool(scaled_gts[:, c], tam_os, tam_os)
        m = small_mask[:, j]                                  # [B, h, w, 1]
        cnt = m.sum()
        if ranks > 1:
            cnt = parallel.all_reduce_sum(cnt)

        def bce_term(logits, neighbor_gt):
            # labels over the window, zero-padded like F.unfold
            ngt = unfold(avg_pool(neighbor_gt, tam_os, tam_os), win)[..., 0]
            lbl = ((cgt - ngt).abs() < cfg.att_thres).to(logits.dtype) \
                * eps_smooth
            bce = (torch.clamp_min(logits, 0) - logits * lbl
                   + torch.log1p(torch.exp(-logits.abs())))
            return ((bce * m).sum() * ranks
                    / torch.clamp_min(cnt * win * win, 1.0))

        loss = 0.5 * (bce_term(attb[:, j], scaled_gts[:, c - 1])
                      + bce_term(attf[:, j], scaled_gts[:, c + 1]))
        terms.append(torch.where(cnt > 0, loss, 0.0))
    return sum(terms) / len(terms)


def temporal_loss(cfg: TaskConfig, alphas, gts, trimasks, fs=None, bs=None,
                  scaled_fgs=None, scaled_bgs=None,
                  global_batch: bool = False):
    """L_dt temporal coherence for S >= 5 (models/model.py:326-345)."""
    s = alphas.shape[1]

    def dt(pred, gt, normalize=True):
        terms = [L.l1_mask(pred[:, c] - pred[:, c + 1],
                           gt[:, c] - gt[:, c + 1], trimasks[:, c],
                           normalize=normalize, global_batch=global_batch)
                 for c in range(1, s - 2)]
        return sum(terms) / len(terms)

    if s < 5:
        return alphas.new_zeros(())
    if cfg.method == "fba":
        nrm = cfg.fba_loss_normalize
        return dt(alphas, gts, nrm) + 0.25 * (dt(fs, scaled_fgs, nrm)
                                              + dt(bs, scaled_bgs, nrm))
    return dt(alphas, gts)


# ---------------------------------------------------------------------------
# Forward drivers
# ---------------------------------------------------------------------------

def _cf(t: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, W, C]`` -> ``[B, S, C, H, W]``."""
    return t.permute(0, 1, 4, 2, 3)


def _cl(t: torch.Tensor) -> torch.Tensor:
    """``[B, S, C, H, W]`` -> ``[B, S, H, W, C]``."""
    return t.permute(0, 1, 3, 4, 2)


def _run_vmn(model, pre, cfg: TaskConfig, bands=None):
    """The full-clip VMN on the preprocessed clip; channels-last results
    (preds, attb, attf, small_mask). Only FBA's head takes extras.

    ``bands`` (``parallel.space.Bands``): the network runs on this rank's
    band of each frame of the whole preprocessed clip, and its results are
    gathered whole on every rank of the space group."""
    if bands is not None:
        band = {k: bands.crop(pre[k], 2)
                for k in ("imgs", "tris", "trimasks", "scaled_imgs")}
        with space.banded(bands):
            outs = _run_vmn(model, band, cfg)
        return tuple(bands.gather_bands(t, 2) for t in outs)
    inputs = torch.cat([pre["imgs"], pre["tris"]], dim=-1)
    extras = ((_cf(pre["scaled_imgs"]), _cf(pre["tris"][..., -2:]))
              if cfg.method == "fba" else None)
    preds, attb, attf, small = model(_cf(inputs), _cf(pre["trimasks"]),
                                     extras)
    return _cl(preds), attb, attf, _cl(small)


def _run_single(model, pre, cfg: TaskConfig, c: int) -> torch.Tensor:
    """A single-frame model on frame ``c`` of the preprocessed clip; its
    prediction ``[B, H, W, Cout]`` channels-last. Only FBA takes extras."""
    inputs = torch.cat([pre["imgs"][:, c], pre["tris"][:, c]], dim=-1)
    inputs = inputs.permute(0, 3, 1, 2)
    if cfg.method != "fba":
        return model(inputs).permute(0, 2, 3, 1)
    extras = (pre["scaled_imgs"][:, c].permute(0, 3, 1, 2),
              pre["tris"][:, c, ..., -2:].permute(0, 3, 1, 2))
    return model(inputs, extras).permute(0, 2, 3, 1)


def _losses(cfg: TaskConfig, preds, pre, start: int, end: int,
            global_batch: bool = False):
    """(L1, L2, L3, alphas, comps, Fs, Bs): FBA's composite losses, or the
    other methods' single-image losses with the ground truth's scaled
    foreground and background as Fs and Bs."""
    if cfg.method == "fba":
        return fba_single_image_losses(cfg, preds, pre, start, end,
                                       global_batch)
    return (*single_image_losses(cfg, preds, pre, start, end, global_batch),
            pre["scaled_fgs"], pre["scaled_bgs"])


def _center_only(pred_c: torch.Tensor, s: int, c: int) -> torch.Tensor:
    """``[B, S, H, W, C]`` holding ``pred_c`` at frame ``c``, zero
    elsewhere."""
    preds = pred_c.new_zeros((pred_c.shape[0], s) + pred_c.shape[1:])
    preds[:, c] = pred_c
    return preds


def forward_single(model, batch: dict, cfg: TaskConfig, radius=None,
                   global_batch: bool = False):
    """FullModel forward (models/model.py:199-246). A single-frame model
    runs the center frame only and is supervised there; a VMN model (the
    TAM-pretrain configuration, pretrain_ddp.py) runs the temporal module
    over all frames and supervises frames 1..S-2 without the video-only
    L_att and L_dt. ``global_batch``: this rank's share of the losses of
    every rank's batch. Returns (losses, aux)."""
    s = batch["a"].shape[1]
    pre = preprocess(batch["a"], batch["fg"], batch["bg"], cfg, radius)
    if cfg.is_vmn:
        preds, _, _, _ = _run_vmn(model, pre, cfg)
        start, end = 1, s - 1
    else:
        c = s // 2
        preds = _center_only(_run_single(model, pre, cfg, c), s, c)
        start, end = c, c + 1
    l1, l2, l3, alphas, comps, fs, bs = _losses(cfg, preds, pre, start, end,
                                                global_batch)
    return ({"L1": l1, "L2": l2, "L3": l3},
            dict(pre=pre, alphas=alphas, comps=comps, Fs=fs, Bs=bs))


def forward_vmd(model, batch: dict, cfg: TaskConfig, radius=None,
                global_batch: bool = False, bands=None):
    """FullModel_VMD forward, the full video loss stack
    (models/model.py:258-357). ``batch``: a, fg, bg ``[B, S, H, W, .]``
    in [0, 255] on the model's device; ``radius``: see :func:`make_trimap`;
    ``global_batch``: this rank's share of the losses of every rank's
    batch; ``bands`` (inference only): the ranks of a space group each
    run the network on one band of every frame (``parallel.space``), the
    preprocessing and the losses whole on each. Returns (losses {L1, L2,
    L3, L_dt, L_att}, aux)."""
    s = batch["a"].shape[1]
    pre = preprocess(batch["a"], batch["fg"], batch["bg"], cfg, radius)
    preds, attb, attf, small_mask = _run_vmn(model, pre, cfg, bands)
    l1, l2, l3, alphas, comps, fs, bs = _losses(cfg, preds, pre, 1, s - 1,
                                                global_batch)
    l_att = attention_loss(cfg, attb, attf, small_mask, pre["scaled_gts"],
                           global_batch=global_batch)
    l_dt = temporal_loss(cfg, alphas, pre["scaled_gts"], pre["trimasks"],
                         fs, bs, pre["scaled_fgs"], pre["scaled_bgs"],
                         global_batch=global_batch)
    losses = {"L1": l1, "L2": l2, "L3": l3, "L_dt": l_dt, "L_att": l_att}
    return losses, dict(pre=pre, alphas=alphas, comps=comps, Fs=fs, Bs=bs)


def forward_eval(model, imgs: torch.Tensor, tris: torch.Tensor,
                 cfg: TaskConfig):
    """EvalModel forward from real trimaps (models/model.py:389-453).
    ``imgs``: ``[B, S, H, W, 3]`` BGR, ``tris``: ``[B, S, H, W, 1]``, f32
    0..255. Returns alphas ``[B, S, H, W, 1]`` (and F, B for FBA) with the
    trimap's values pasted outside the unknown region; the frames the model
    does not predict (the clip's ends for VMN, all but the center for a
    single-frame model) are zero."""
    s = imgs.shape[1]
    pre = preprocess_eval(imgs, tris, cfg)
    if cfg.is_vmn:
        preds = _run_vmn(model, pre, cfg)[0]
        start, end = 1, s - 1
    else:
        c = s // 2
        preds = _center_only(_run_single(model, pre, cfg, c), s, c)
        start, end = c, c + 1
    mask = pre["trimasks"] > 0.5
    gt_tri = tris * IMG_SCALE
    fba = cfg.method == "fba"
    outs_a, outs_f, outs_b = [], [], []
    for i in range(s):
        if start <= i < end:
            outs_a.append(torch.where(mask[:, i], preds[:, i, ..., 0:1],
                                      gt_tri[:, i]))
            if fba:
                img = pre["scaled_imgs"][:, i]
                outs_f.append(torch.where(mask[:, i], preds[:, i, ..., 1:4],
                                          img))
                outs_b.append(torch.where(mask[:, i], preds[:, i, ..., 4:7],
                                          img))
        else:
            outs_a.append(torch.zeros_like(gt_tri[:, i]))
            if fba:
                outs_f.append(torch.zeros_like(pre["scaled_imgs"][:, i]))
                outs_b.append(outs_f[-1])
    alphas = torch.stack(outs_a, 1)
    if fba:
        return alphas, torch.stack(outs_f, 1), torch.stack(outs_b, 1)
    return alphas
