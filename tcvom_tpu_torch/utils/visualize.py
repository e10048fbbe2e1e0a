"""Training-image dumps (port of tcvom_tpu/utils/visualize.py, reference
write_image, train_ddp.py:27-38): periodic grids of img / trimap / alpha /
comp / gt / fg / bg, and the validation's pred / tri / gt triplets. PNGs
go through the port's writer (``utils/imageio.py``)."""
from __future__ import annotations

import os

import numpy as np
import torch

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
