"""VideoMatting108 data (port of tcvom_tpu/data/vmd.py): clip sampling
with mirrored edges, paired FG(RGBA)/BG frames through frame_corr.json;
in training a random temporal flip, a scale-crop-resize re-rolled until
unknown pixels exist, and pixel and JPEG augmentation, drawn from
``(seed, epoch, idx)``; in validation the frames padded to the network's
shape (the reference's precomputed val path) or resized to it. Unless
``no_flow``, the quantized flow PNGs (/100, NaN-invalid) of the centre
frames come with each item, cropped and resized with the frames
(:func:`flow_crop_and_resize`) or padded with NaN. Items are float32
``[S, H, W, C]`` in BGR 0-255, as the JAX package yields them;
``data/loader.py::make_loader`` batches them.
"""
from __future__ import annotations

import json
import os
from functools import partial
from typing import Sequence

import numpy as np
import torch.utils.data

from tcvom_tpu_torch.data.augment import JpegAug, PixelAug, resize_bilinear_ac
from tcvom_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_UNCHANGED,
                                           imread)

FLOW_QUANTIZATION_SCALE = 100.0
FG_FOLDER = "FG_done"
BG_FOLDER = "BG_done"
FLOW_FOLDER = "flow_png"
# reference precomputed-val padding value (BGR ImageNet means, VMD.py:264)
IMG_PADDING_VALUE = (103.53, 116.28, 123.675)


def parse_samples(video_names: Sequence[str], frame_corr: dict, length: int):
    """Every frame becomes a sample with a mirrored-edge +-(S//2) window
    (reference VMD.py:168-184)."""
    samples = []
    for v in video_names:
        fns = [k for k in sorted(frame_corr) if os.path.dirname(k) == v]
        for i in range(len(fns)):
            c = length // 2
            sample = [None] * length
            sample[c] = fns[i]
            for j in range(c):
                sample[c - j - 1] = (fns[i - j - 1] if i - j - 1 >= 0
                                     else fns[-(i - j - 1)])
                sample[c + j + 1] = (fns[i + j + 1] if i + j + 1 < len(fns)
                                     else fns[len(fns) - (i + j + 1) - 2])
            samples.append(sample)
    return samples


def read_flow_png(path: str) -> np.ndarray:
    """Quantized flow PNG: int16 dx, dy in the first channels / 100, the
    last channel validity; invalid -> NaN (reference VMD.py:203-213)."""
    x = imread(path, IMREAD_UNCHANGED)
    flow = np.float32(x[..., :-1].astype(np.int16))
    flow[x[..., -1] == 0] = np.nan
    return flow / FLOW_QUANTIZATION_SCALE


def flow_crop_and_resize(flow: np.ndarray, ph: int, pw: int, nsize,
                         out_shape) -> np.ndarray:
    """Flow ``[H, W, 2]`` cropped to ``nsize`` at (ph, pw) (the whole
    frame when ``nsize`` is None) and resampled to ``out_shape``, NaN where
    invalid (reference VMD.py:68-126; tcvom_tpu/data/vmd.py:63-117): a
    pixel whose flow turns by more than 45 degrees or changes magnitude by
    50 or more against its lower or right neighbour is invalid, unless
    both vectors are short (norms summing to under 2) or one is zero; the
    flow is resized align-corners bilinear (NaNs propagate), masked by the
    validity at the floor of each source coordinate, rescaled to the
    output grid, and NaN where it points out of the frame."""
    if nsize is not None:
        flow = flow[ph:ph + nsize[0], pw:pw + nsize[1]]
    else:
        nsize = flow.shape[:2]
    oh, ow = out_shape

    def gradient_check(fa, fb):
        dot = (fa * fb).sum(-1)
        na = np.sqrt((fa ** 2).sum(-1))
        nb = np.sqrt((fb ** 2).sum(-1))
        nab = na * nb
        with np.errstate(invalid="ignore", divide="ignore"):
            cosv = np.abs(dot / nab).clip(0, 1.0 - 1e-6)
        angle_valid = np.arccos(cosv) <= np.pi / 4
        angle_valid[nab == 0] = True
        angle_valid[(na + nb) < 2] = True
        mag_valid = np.abs(na - nb) < 50
        return (angle_valid & mag_valid).astype(np.int32)

    gradh = np.pad(gradient_check(flow[:-1], flow[1:]), ((0, 1), (0, 0)),
                   constant_values=1)
    gradw = np.pad(gradient_check(flow[:, :-1], flow[:, 1:]),
                   ((0, 0), (0, 1)), constant_values=1)
    valid = gradh * gradw

    interp = resize_bilinear_ac(flow, (oh, ow), round_floor_half=False)
    ys = np.arange(oh, dtype=np.float32) * ((nsize[0] - 1) / float(oh - 1))
    xs = np.arange(ow, dtype=np.float32) * ((nsize[1] - 1) / float(ow - 1))
    cy = np.clip(np.floor(ys).astype(np.int64), 0, nsize[0] - 1)
    cx = np.clip(np.floor(xs).astype(np.int64), 0, nsize[1] - 1)
    interp = np.where(valid[cy][:, cx].astype(bool)[..., None], interp,
                      np.nan)
    interp[..., 0] /= nsize[1] / float(ow)
    interp[..., 1] /= nsize[0] / float(oh)

    gy, gx = np.meshgrid(np.arange(oh, dtype=np.float32),
                         np.arange(ow, dtype=np.float32), indexing="ij")
    fx = gx + interp[..., 0]
    fy = gy + interp[..., 1]
    interp[(fx < 0) | (fy < 0) | (fx > ow - 1) | (fy > oh - 1)] = np.nan
    return interp


class VideoMattingDataset(torch.utils.data.Dataset):
    """``mode='train'`` or ``'val'``; items ``dict(a, fg, bg[, wb, wf],
    idx)`` of ``image_shape``. A key is ``(epoch, idx)``
    (``data/loader.py``). In val the frames come from ``precomputed_val``
    padded, or from ``data_root`` resized when it is None. ``wb``, ``wf``:
    the backward and forward flow of the frames that have one (the centre
    frames), NaN for the others."""

    def __init__(self, data_root: str, image_shape, mode: str,
                 use_subset: bool = False, no_flow: bool = False,
                 precomputed_val: str | None = None, sample_length: int = 5,
                 plus1: bool = False, seed: int = 0):
        if mode not in ("train", "val"):
            raise ValueError(mode)
        self.data_root = data_root
        self.mode = mode
        self.no_flow = no_flow
        self.precomputed_val = precomputed_val
        self.sample_length = sample_length
        self.image_shape = ([image_shape[0] + 1, image_shape[1] + 1] if plus1
                            else list(image_shape))
        setname = ("{}_videos_subset.txt" if use_subset
                   else "{}_videos.txt").format(mode)
        with open(os.path.join(data_root, "frame_corr.json")) as f:
            self.frame_corr = json.load(f)
        with open(os.path.join(data_root, setname)) as f:
            videos = [v.strip() for v in f if v.strip()]
        self.samples = parse_samples(videos, self.frame_corr, sample_length)
        self.seed = seed

    def _item_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        """The item's own RandomState, from (seed, epoch, idx) alone
        (tcvom_tpu/data/vmd.py:150-157)."""
        return np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 8_191 + idx) % (2**31 - 1))

    def __len__(self):
        return len(self.samples)

    def _read_frame(self, name: str, root: str):
        f = imread(os.path.join(root, FG_FOLDER, name), IMREAD_UNCHANGED)
        bgp = os.path.join(root, BG_FOLDER, self.frame_corr[name])
        if not os.path.exists(bgp):
            bgp = os.path.splitext(bgp)[0] + ".png"
        bg = np.float32(imread(bgp, IMREAD_COLOR))
        return np.float32(f[..., :-1]), bg, np.float32(f[..., -1:])

    def _shape_aug(self, fgs, bgs, alphas, rng,
                   scales=(1.0, 1.25, 1.5, 2.0, 1.75)):
        """Random scale crop of the whole clip, re-rolled until every
        frame keeps unknown pixels (reference shape_aug, VMD.py:128-166;
        tcvom_tpu/data/vmd.py:172-199): the scales that fit the frame,
        the last crop after 1000 tries. Returns the crops and the crop
        ``(ph, pw, (nh, nw))``, by which the flow is cropped too."""
        h, w = alphas[0].shape[:2]
        size = self.image_shape
        if size[0] != size[1]:
            raise ValueError(f"training crops are square, got {size}")
        fitting = [s for s in scales
                   if int(size[0] * s) < h and int(size[1] * s) < w] or [
                       min(h - 1, w - 1) / float(size[0])]

        def crop(imgs):
            return [resize_bilinear_ac(x[ph:ph + nh, pw:pw + nw], size)
                    for x in imgs]

        for _ in range(1000):
            scale = float(rng.choice(fitting))
            nh, nw = int(size[0] * scale), int(size[1] * scale)
            ph = rng.randint(0, h - nh)
            pw = rng.randint(0, w - nw)
            pa = crop(alphas)
            if all(np.sum((x > 0) & (x < 255)) >= 1 for x in pa):
                break
        return crop(fgs), crop(bgs), pa, (ph, pw, (nh, nw))

    def __getitem__(self, key):
        epoch, idx = key
        sample = list(self.samples[idx])
        rng = self._item_rng(epoch, idx)
        if self.mode == "train" and rng.rand() > 0.5:
            sample = sample[::-1]
        root = (self.data_root if self.precomputed_val is None
                else self.precomputed_val)
        fgs, bgs, alphas = (list(x) for x in zip(
            *[self._read_frame(n, root) for n in sample]))
        if self.mode == "train":
            fgs, bgs, alphas, (ph, pw, nsize) = self._shape_aug(
                fgs, bgs, alphas, rng)
            fit_flow = partial(flow_crop_and_resize, ph=ph, pw=pw,
                               nsize=nsize, out_shape=self.image_shape)
            pixel_aug = PixelAug(rng)
            p_fg, p_bg = pixel_aug.sample(), pixel_aug.sample()
            jpeg = JpegAug(rng).sample()
            fgs = [np.float32(JpegAug.apply(
                PixelAug.apply(np.uint8(f), p_fg), jpeg)) for f in fgs]
            bgs = [np.float32(PixelAug.apply(np.uint8(b), p_bg))
                   for b in bgs]
        elif self.precomputed_val is not None:
            fgs = [self._pad(f, IMG_PADDING_VALUE) for f in fgs]
            bgs = [self._pad(b, IMG_PADDING_VALUE) for b in bgs]
            alphas = [self._pad(a, 0.0) for a in alphas]
            fit_flow = partial(self._pad, value=np.nan)
        else:
            fgs, bgs, alphas = ([resize_bilinear_ac(x, self.image_shape)
                                 for x in xs] for xs in (fgs, bgs, alphas))
            fit_flow = partial(flow_crop_and_resize, ph=0, pw=0, nsize=None,
                               out_shape=self.image_shape)
        out = {"a": np.stack(alphas).astype(np.float32),
               "fg": np.stack(fgs).astype(np.float32),
               "bg": np.stack(bgs).astype(np.float32),
               "idx": np.int32(idx)}
        if not self.no_flow:
            out["wb"], out["wf"] = self._flows(sample, fit_flow)
        return out

    def _flows(self, sample, fit):
        """wb and wf ``[S, H, W, 2]``: the centre frames' backward and
        forward flow, each read and brought to ``image_shape`` by ``fit``
        as the frames were, NaN elsewhere."""
        s = len(sample)
        dn = os.path.dirname(sample[0])
        fns = [os.path.splitext(os.path.basename(n))[0] for n in sample]

        def flow(a, b):
            return fit(read_flow_png(os.path.join(
                self.data_root, FLOW_FOLDER, dn, f"flow_{a}_{b}.png")))

        nanf = np.full(self.image_shape + [2], np.nan, np.float32)
        wb, wf = [nanf] * s, [nanf] * s
        for i in range(2, s - 2):
            wf[i] = flow(fns[i], fns[i + 1])
            wb[i] = flow(fns[i], fns[i - 1])
        wf[1] = flow(fns[1], fns[2])
        wb[-2] = flow(fns[-2], fns[-3])
        return np.stack(wb), np.stack(wf)

    def _pad(self, t: np.ndarray, value) -> np.ndarray:
        h, w = t.shape[:2]
        ph, pw = self.image_shape[0] - h, self.image_shape[1] - w
        if ph == 0 and pw == 0:
            return t
        if ph < 0 or pw < 0:
            raise ValueError(f"frame {t.shape[:2]} larger than "
                             f"{self.image_shape}")
        if np.isscalar(value):
            return np.pad(t, ((0, ph), (0, pw), (0, 0)),
                          constant_values=value)
        out = np.pad(t, ((0, ph), (0, pw), (0, 0)))
        out[h:] = np.asarray(value, t.dtype)
        out[:, w:] = np.asarray(value, t.dtype)
        return out
