"""Adobe-DIM data: three fake video frames synthesized per still by affine
chains (port of tcvom_tpu/data/dim.py, reference dataset/DIM.py:17-356).

Training: resize to the minimum shape, a uniform crop to it, the 3-frame
affine synthesis re-rolled until each frame keeps unknown pixels, then a
flip and a random {512..768} crop resized to ``image_shape``; every draw
from ``(seed, epoch, idx)``. Evaluation (:class:`DIMEvalDataset`,
``pred_single --dataset adobe``): the still brought to the grid by
``val_mode``'s rule, then the synthesis' fixed steps; nothing is drawn.
Items are float32 ``[3, H, W, C]`` in BGR 0-255. The warps and resizes
need OpenCV (cv2).
"""
from __future__ import annotations

import os

import numpy as np
import torch.utils.data

from tcvom_tpu_torch.data.augment import need_cv2
from tcvom_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                           imread)


def _rotate(M, center, angle, scale):
    Mn = need_cv2("the DIM frame synthesis").getRotationMatrix2D(
        (float(center[0]), float(center[1])), float(angle), float(scale))
    return M @ np.concatenate([Mn, [[0, 0, 1]]])


def _move(M, vec):
    return M @ np.float32([[1, 0, vec[0]], [0, 1, vec[1]], [0, 0, 1]])


def _apply_var(M, var):
    center, move, angle, scale = var
    return _move(_rotate(M, center, angle, scale), move)


def synth_frames3(fg, bg, alpha, rng: np.random.RandomState | None):
    """3-frame affine synthesis (reference make_frames3, DIM.py:97-158;
    tcvom_tpu/data/dim.py:40-105): a random placement of the foreground,
    then one random step of the foreground and of the background each
    way; with ``rng=None`` the evaluation variant (DIM.py:310-356): the
    foreground in place, fixed steps of -5 px, -2 degrees, x0.99 (the
    foreground) and +5 px, +2 degrees, x1.01 (the background). Returns
    (fgs, bgs, alphas ``[H, W, 1]``, good_sample: every frame keeps >= 400
    unknown pixels)."""
    cv2 = need_cv2("the DIM frame synthesis")
    bh, bw = bg.shape[:2]
    fh, fw = fg.shape[:2]
    I = np.eye(3, dtype=np.float32)

    if rng is None:
        FM0 = I
        fstep = (np.array([fw * 0.5, fh * 0.5]), np.array([-5, -5]), -2,
                 0.99)
        bstep = (np.array([fw * 0.5, fh * 0.5]), np.array([5, 5]), 2, 1.01)
    else:
        def rand_var(w, h, move_max=20, rot_center=10, rot_angle=2,
                     smin=1.0, smax=1.0):
            center = rot_center * 2 * (rng.random_sample(2) - 0.5) + \
                np.array([w / 2, h / 2], np.float32)
            move = rng.randint(-move_max, move_max, 2)
            angle = (rng.random_sample() - 0.5) * 2.0 * rot_angle
            scale = rng.random_sample() * (smax - smin) + smin
            return center, move, angle, scale

        dh, dw = (bh - fh) / 2.0, (bw - fw) / 2.0
        rh = (rng.random_sample() - 0.5) * 2.0
        rw = (rng.random_sample() - 0.5) * 2.0
        FM0 = _move(I, [rh * dh, rw * dw])
        ff = rand_var(fw, fh, move_max=200, rot_angle=10, smin=0.9,
                      smax=1.1)
        fstep = rand_var(fw, fh)
        bstep = rand_var(bw, bh, rot_center=0, rot_angle=0)
        FM0 = _apply_var(I, ff) @ FM0

    FMs = _apply_var(I, fstep)
    BMs = _apply_var(I, bstep)
    FM_ = [np.linalg.inv(FMs), I, FMs]
    BM_ = [np.linalg.inv(BMs), I, BMs]
    fgs, bgs, alphas = [], [], []
    good = True
    for i in range(3):
        FM = FM_[i] @ FM0
        fgs.append(cv2.warpPerspective(fg, FM, (bw, bh)))
        bgs.append(cv2.warpPerspective(bg, BM_[i], (bw, bh)))
        a = cv2.warpPerspective(alpha, FM, (bw, bh))[..., None]
        alphas.append(a)
        if np.sum((a > 0) & (a < 255)) < 400:
            good = False
    return fgs, bgs, alphas, good


class DIMPretrainDataset(torch.utils.data.Dataset):
    """The TAM pretrain's training items (``tools/train.py --dataset
    dim``), or with ``is_train=False`` the evaluation items of
    :class:`DIMEvalDataset`: ``dict(a, fg, bg, idx[, og_shape])``, 3
    frames. A key is ``(epoch, idx)`` (``data/loader.py``); evaluation
    items do not depend on it. The lists are the reference's: for
    training ``fg_train_set_old.txt`` ('<fg> <alpha>' lines, each for 100
    backgrounds) and ``bg_train_set.txt``, for evaluation
    ``fg_val_set.txt`` and ``bg_val_set.txt`` line by line."""

    CROP_SIZES = (512, 576, 640, 704, 768)
    VAL_MODES = ("gca", "dim", "origin", "resize")
    ORIGIN_SHAPE = 2112
    sample_length = 3

    def __init__(self, data_root: str, image_shape=None, min_shape: int = 800,
                 val_mode: str | None = None, plus1: bool = True,
                 is_train: bool = True, seed: int = 0):
        self.data_root = data_root
        self.is_train = is_train
        self.val_mode = val_mode
        self.min_shape = min_shape
        if is_train:
            self.image_shape = tuple(image_shape)
        elif val_mode not in self.VAL_MODES:
            raise ValueError(f"val_mode {val_mode!r}, not one of "
                             f"{self.VAL_MODES}")
        elif val_mode == "origin":
            self.image_shape = (self.ORIGIN_SHAPE, self.ORIGIN_SHAPE)
        else:
            self.image_shape = (min_shape, min_shape)
        if plus1:
            self.image_shape = (self.image_shape[0] + 1,
                                self.image_shape[1] + 1)
        prefix = "train" if is_train else "val"
        with open(os.path.join(data_root, f"bg_{prefix}_set.txt")) as f:
            bg_set = [line.strip() for line in f]
        fg_list = "fg_train_set_old.txt" if is_train else "fg_val_set.txt"
        with open(os.path.join(data_root, fg_list)) as f:
            fg_lines = [line.strip() for line in f]
        if is_train:
            fg_lines = [fg_lines[i // 100] for i in range(len(bg_set))]
        if len(fg_lines) != len(bg_set):
            raise ValueError(f"{fg_list} lists {len(fg_lines)} stills, "
                             f"bg_{prefix}_set.txt {len(bg_set)}")
        self.sample_fn = [(*fg.split(" ")[:2], b)
                          for fg, b in zip(fg_lines, bg_set)]
        self.seed = seed

    def _item_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        """The item's own RandomState, from (seed, epoch, idx) alone
        (tcvom_tpu/data/dim.py:141-145)."""
        return np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 8_191 + idx) % (2**31 - 1))

    def __len__(self):
        return len(self.sample_fn)

    def _resize_ratio(self, img, a=None, use_short=True, force=False,
                      interpolation=None):
        """Scale so that the short side (the long side without
        ``use_short``) reaches ``min_shape``, when it is shorter or with
        ``force`` (reference DIM.py:177-214), clipped to 0..255, as
        uint8."""
        cv2 = need_cv2("the DIM resize")
        interpolation = interpolation or cv2.INTER_AREA
        tgt = self.min_shape
        side = min(img.shape[:2]) if use_short else max(img.shape[:2])
        if side < tgt or force:
            r = tgt / float(side)
            bound = max if use_short else min
            new = (bound(int(img.shape[1] * r), tgt),
                   bound(int(img.shape[0] * r), tgt))
            img = np.clip(cv2.resize(np.float32(img), new,
                                     interpolation=interpolation), 0, 255)
            if a is not None:
                a = np.clip(cv2.resize(np.float32(a), new,
                                       interpolation=interpolation), 0, 255)
        if a is not None:
            return np.uint8(img), np.uint8(a)
        return np.uint8(img)

    @staticmethod
    def _crop(imgs, size: int, rng):
        """CropToFixedSize at one uniform offset for the group."""
        h, w = imgs[0].shape[:2]
        th, tw = min(size, h), min(size, w)
        y0 = rng.randint(0, h - th + 1)
        x0 = rng.randint(0, w - tw + 1)
        return [im[y0:y0 + th, x0:x0 + tw] for im in imgs]

    def _eval_grid(self, fg, a, bg):
        """The still on the evaluation grid (tcvom_tpu/data/dim.py:
        187-214): ``resize`` scales its long side to ``min_shape``; the
        background is scaled (cubic) to cover the foreground and cropped
        to it; ``dim`` resizes all three to multiples of 32; then each is
        padded to ``image_shape``, reflected for ``gca``, with zeros
        otherwise. A still larger than the grid raises ValueError."""
        cv2 = need_cv2("the DIM evaluation resize")

        def cubic(img, size):
            return np.uint8(np.clip(cv2.resize(
                np.float32(img), size, interpolation=cv2.INTER_CUBIC),
                0, 255))

        if self.val_mode == "resize":
            fg, a = self._resize_ratio(fg, a, use_short=False, force=True)
        ratio = max(fg.shape[0] / bg.shape[0], fg.shape[1] / bg.shape[1])
        bg = cubic(bg, (int(np.ceil(bg.shape[1] * ratio)),
                        int(np.ceil(bg.shape[0] * ratio))))
        bg = bg[:fg.shape[0], :fg.shape[1]]
        if self.val_mode == "dim":
            fg, a, bg = (cubic(x, (int(np.ceil(x.shape[1] / 32.0) * 32),
                                   int(np.ceil(x.shape[0] / 32.0) * 32)))
                         for x in (fg, a, bg))
        ph = self.image_shape[0] - fg.shape[0]
        pw = self.image_shape[1] - fg.shape[1]
        if ph < 0 or pw < 0:
            raise ValueError(
                f"eval image {fg.shape[:2]} exceeds the {self.image_shape} "
                f"grid (val_mode={self.val_mode!r}); raise min_shape or use "
                "val_mode='resize'")
        mode = "reflect" if self.val_mode == "gca" else "constant"
        return (np.pad(fg, ((0, ph), (0, pw), (0, 0)), mode=mode),
                np.pad(a, ((0, ph), (0, pw)), mode=mode),
                np.pad(bg, ((0, ph), (0, pw), (0, 0)), mode=mode))

    def __getitem__(self, key):
        cv2 = need_cv2("the DIM items")
        epoch, idx = key
        fg_fn, a_fn, bg_fn = self.sample_fn[idx]
        ofg = imread(os.path.join(self.data_root, fg_fn), IMREAD_COLOR)
        oa = imread(os.path.join(self.data_root, a_fn), IMREAD_GRAYSCALE)
        obg = imread(os.path.join(self.data_root, bg_fn), IMREAD_COLOR)
        if not self.is_train:
            fg, a, bg = self._eval_grid(ofg, oa, obg)
            fgs, bgs, alphas, _ = synth_frames3(fg, bg, a, None)
            return self._item(fgs, bgs, alphas, idx,
                              og_shape=np.asarray(ofg.shape[:2], np.int32))

        rng = self._item_rng(epoch, idx)
        while True:
            fg, a = self._resize_ratio(ofg, oa)
            bg = self._resize_ratio(obg, interpolation=cv2.INTER_CUBIC)
            fg, a = self._crop([fg, a], self.min_shape, rng)
            (bg,) = self._crop([bg], self.min_shape, rng)
            fgs, bgs, alphas, good = synth_frames3(fg, bg, a, rng)
            if good:
                break

        flip = rng.rand() < 0.5
        crop = int(rng.choice(self.CROP_SIZES))
        h, w = fgs[0].shape[:2]
        y0 = rng.randint(0, max(h - crop, 0) + 1)
        x0 = rng.randint(0, max(w - crop, 0) + 1)

        def proc(img, inter):
            im = img[:, ::-1] if flip else img
            im = im[y0:y0 + crop, x0:x0 + crop]
            out = cv2.resize(np.float32(im),
                             (self.image_shape[1], self.image_shape[0]),
                             interpolation=inter)
            return np.clip(out, 0, 255)

        return self._item([proc(f, cv2.INTER_AREA) for f in fgs],
                          [proc(b, cv2.INTER_CUBIC) for b in bgs],
                          [proc(x, cv2.INTER_AREA) for x in alphas], idx)

    @staticmethod
    def _item(fgs, bgs, alphas, idx: int, **extra) -> dict:
        return {"a": np.stack([np.float32(x).reshape(x.shape[0], x.shape[1],
                                                     1) for x in alphas]),
                "fg": np.stack([np.float32(x) for x in fgs]),
                "bg": np.stack([np.float32(x) for x in bgs]),
                "idx": np.int32(idx), **extra}


class DIMEvalDataset(DIMPretrainDataset):
    """The Adobe-DIM evaluation items (``pred_single --dataset adobe``):
    ``DIMPretrainDataset(is_train=False)`` on ``val_mode``'s grid, each
    with its still's ``og_shape`` (int32 ``[2]``)."""

    def __init__(self, **kwargs):
        super().__init__(is_train=False, **kwargs)
