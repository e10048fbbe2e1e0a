"""Adobe-DIM pretrain data: three fake video frames synthesized per still
by random affine chains (port of the training half of
tcvom_tpu/data/dim.py, reference dataset/DIM.py:17-214).

Resize to the minimum shape, a uniform crop to it, the 3-frame affine
synthesis re-rolled until each frame keeps unknown pixels, then a flip and
a random {512..768} crop resized to ``image_shape``; every draw from
``(seed, epoch, idx)``. Items are float32 ``[3, H, W, C]`` in BGR 0-255.
The warps and resizes need OpenCV (cv2). The evaluation variant
(``DIMEvalDataset``, ``pred_single --dataset adobe``) is not ported:
ROADMAP.md Queue 1 item 11.
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


def synth_frames3(fg, bg, alpha, rng: np.random.RandomState):
    """3-frame affine synthesis (reference make_frames3, DIM.py:97-158;
    tcvom_tpu/data/dim.py:40-105, training variant): a random placement
    of the foreground, then one random step of the foreground and of the
    background each way. Returns (fgs, bgs, alphas ``[H, W, 1]``,
    good_sample: every frame keeps >= 400 unknown pixels)."""
    cv2 = need_cv2("the DIM frame synthesis")
    bh, bw = bg.shape[:2]
    fh, fw = fg.shape[:2]
    I = np.eye(3, dtype=np.float32)

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
    ff = rand_var(fw, fh, move_max=200, rot_angle=10, smin=0.9, smax=1.1)
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
    dim``): ``dict(a, fg, bg, idx)``, 3 frames. A key is
    ``(epoch, idx)`` (``data/loader.py``). The lists are the reference's:
    ``fg_train_set_old.txt`` ('<fg> <alpha>' lines, each for 100
    backgrounds) and ``bg_train_set.txt``."""

    CROP_SIZES = (512, 576, 640, 704, 768)
    sample_length = 3

    def __init__(self, data_root: str, image_shape, min_shape: int = 800,
                 plus1: bool = True, seed: int = 0):
        self.data_root = data_root
        self.min_shape = min_shape
        self.image_shape = tuple(image_shape)
        if plus1:
            self.image_shape = (self.image_shape[0] + 1,
                                self.image_shape[1] + 1)
        with open(os.path.join(data_root, "bg_train_set.txt")) as f:
            bg_set = [line.strip() for line in f]
        with open(os.path.join(data_root, "fg_train_set_old.txt")) as f:
            fg_lines = [line.strip() for line in f]
        self.sample_fn = [(*fg_lines[i // 100].split(" ")[:2], b)
                          for i, b in enumerate(bg_set)]
        self.seed = seed

    def _item_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        """The item's own RandomState, from (seed, epoch, idx) alone
        (tcvom_tpu/data/dim.py:141-145)."""
        return np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 8_191 + idx) % (2**31 - 1))

    def __len__(self):
        return len(self.sample_fn)

    def _resize_ratio(self, img, a=None, interpolation=None):
        """Upscale so that the short side reaches ``min_shape`` (reference
        DIM.py:177-214), clipped to 0..255, as uint8."""
        cv2 = need_cv2("the DIM pretrain resize")
        interpolation = interpolation or cv2.INTER_AREA
        tgt = self.min_shape
        short = min(img.shape[:2])
        if short < tgt:
            r = tgt / float(short)
            new = (max(int(img.shape[1] * r), tgt),
                   max(int(img.shape[0] * r), tgt))
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

    def __getitem__(self, key):
        cv2 = need_cv2("the DIM pretrain items")
        epoch, idx = key
        fg_fn, a_fn, bg_fn = self.sample_fn[idx]
        rng = self._item_rng(epoch, idx)
        ofg = imread(os.path.join(self.data_root, fg_fn), IMREAD_COLOR)
        oa = imread(os.path.join(self.data_root, a_fn), IMREAD_GRAYSCALE)
        obg = imread(os.path.join(self.data_root, bg_fn), IMREAD_COLOR)
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

        fgs = [proc(f, cv2.INTER_AREA) for f in fgs]
        bgs = [proc(b, cv2.INTER_CUBIC) for b in bgs]
        alphas = [proc(x, cv2.INTER_AREA) for x in alphas]
        return {
            "a": np.stack([np.float32(x).reshape(x.shape[0], x.shape[1], 1)
                           for x in alphas]),
            "fg": np.stack([np.float32(x) for x in fgs]),
            "bg": np.stack([np.float32(x) for x in bgs]),
            "idx": np.int32(idx),
        }
