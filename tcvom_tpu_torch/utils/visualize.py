"""Training-image dumps (port of tcvom_tpu/utils/visualize.py, reference
write_image, train_ddp.py:27-38): periodic grids of img / trimap / alpha /
comp / gt / fg / bg, and the validation's pred / tri / gt triplets; and
the evaluation tools' captioned images (``--vis``): ``pred_single``'s
pred | gt (:func:`write_vis_image`) and ``calc_metric``'s error overlay |
gt (:func:`write_error_vis`). PNGs go through the port's writer
(``utils/imageio.py``); the captioned images need OpenCV (cv2), which
draws their text."""
from __future__ import annotations

import os

import numpy as np
import torch

from tcvom_tpu_torch.data.augment import need_cv2
from tcvom_tpu_torch.utils.imageio import imwrite


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_image_grid(arr, path: str, nrow: int = 8, padding: int = 2):
    """``arr``: [N, H, W, C] floats in [0, 1] (RGB or one channel), tiled
    ``nrow`` to a row like torchvision.utils.save_image."""
    arr = _np(arr)
    n, h, w, c = arr.shape
    rows = -(-n // nrow)
    grid = np.zeros((rows * (h + padding) + padding,
                     nrow * (w + padding) + padding, c), arr.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = arr[i]
    img = np.uint8(np.clip(grid, 0, 1) * 255)
    imwrite(path, np.ascontiguousarray(img[..., ::-1] if c == 3
                                       else img[..., 0]))


def write_val_triplets(outdir: str, alphas, tris, gts, start_idx: int) -> int:
    """``<n>_pred.png``, ``_tri.png`` and ``_gt.png`` of each center frame
    of a validation batch (train_ddp.py:129-138); ``alphas``, ``tris``,
    ``gts``: [B, H, W, 1] in [0, 1]. Returns the next index."""
    os.makedirs(outdir, exist_ok=True)
    alphas, tris, gts = (_np(t) for t in (alphas, tris, gts))
    for i in range(alphas.shape[0]):
        n = start_idx + i
        for tag, t in (("pred", alphas), ("tri", tris), ("gt", gts)):
            imwrite(os.path.join(outdir, f"{n:05d}_{tag}.png"),
                    np.uint8(np.clip(t[i, ..., 0], 0, 1) * 255))
    return start_idx + alphas.shape[0]


def write_training_images(outdir: str, aux: dict, step: int,
                          max_batch: int = 4) -> None:
    """The seven ``vis_<name>_<step>.png`` grids of ``MattingTrainer.
    vis_step``'s output, a clip to a row, at most ``max_batch`` clips."""
    pre = aux["pre"]
    os.makedirs(outdir, exist_ok=True)
    for name, tensor in (("image", pre["scaled_imgs"]),
                         ("tris", pre["trimasks"]), ("as", aux["alphas"]),
                         ("comps", aux["comps"]),
                         ("gts", pre["scaled_gts"]), ("fgs", aux["Fs"]),
                         ("bgs", aux["Bs"])):
        t = _np(tensor)[:max_batch]
        b, s = t.shape[:2]
        save_image_grid(t.reshape((b * s,) + t.shape[2:]),
                        os.path.join(outdir, f"vis_{name}_{step}.png"),
                        nrow=s)


def _write_captioned(vis_dir: str, name: str, left: np.ndarray, g8, t8,
                     sad: float, mse: float, pcount: int) -> None:
    """``left`` (BGR uint8) beside the gt ``g8`` in gray, the trimap
    ``t8`` at a quarter of the size inset at the bottom centre, a 100-px
    blue strip below with the green caption ``SAD= MSE= valid_pxs=``
    (reference pred_single.py:194-208, calc_metric.py:103-126); written
    to ``<vis_dir>/<name without extension>.png``."""
    cv2 = need_cv2("--vis")
    h, w = g8.shape
    inset = cv2.resize(t8, (w // 4, h // 4), interpolation=cv2.INTER_NEAREST)
    comp = np.concatenate([left, np.stack([g8] * 3, -1)], axis=1)
    x0 = comp.shape[1] // 2 - inset.shape[1] // 2
    comp[-inset.shape[0]:, x0:x0 + inset.shape[1]] = inset[..., None]
    comp = cv2.copyMakeBorder(comp, 0, 100, 0, 0, cv2.BORDER_CONSTANT,
                              value=(255, 0, 0))
    caption = "SAD={:.6f} MSE={:.6f} valid_pxs={}".format(sad, mse, pcount)
    comp = cv2.putText(comp, caption, (20, comp.shape[0] - 20),
                       cv2.FONT_HERSHEY_SIMPLEX, 2, (0, 255, 0), 3)
    fn = os.path.splitext(name)[0]
    os.makedirs(os.path.join(vis_dir, os.path.dirname(fn)), exist_ok=True)
    imwrite(os.path.join(vis_dir, fn + ".png"), comp)


def write_vis_image(vis_dir: str, name: str, a8, g8, t8, sad: float,
                    mse: float, pcount: int) -> None:
    """``pred_single --vis`` (tools/pred_single.py:55-71): the predicted
    matte beside the gt, uint8 ``[H, W]`` each, with the trimap ``t8``'s
    inset and the sample's SAD, MSE and unknown-pixel count."""
    _write_captioned(vis_dir, name, np.stack([a8] * 3, -1), g8, t8, sad,
                     mse, pcount)


def write_error_vis(vis_dir: str, name: str, a, g, t, sad: float, mse: float,
                    pcount: int) -> None:
    """``calc_metric --vis`` (tools/calc_metric.py:108-133): the predicted
    matte ``a`` with its error ``|a - g|`` laid over it in red, beside the
    gt ``g`` (both f32 in [0, 1]), with the trimap ``t`` (f32, 0..255)
    inset and the frame's SAD, MSE and unknown-pixel count."""
    left = np.stack([np.uint8(a * 255)] * 3, -1).astype(np.float32) / 255.0
    diff = np.abs(a.astype(np.float32) - g)
    left[..., 2] = diff + (1 - diff) * left[..., 2]
    _write_captioned(vis_dir, name, np.uint8(left * 255), np.uint8(g * 255),
                     np.uint8(t), sad, mse, pcount)
