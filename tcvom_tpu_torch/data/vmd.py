"""VideoMatting108 validation data (port of the ``mode="val"`` pad path of
tcvom_tpu/data/vmd.py): clip sampling with mirrored edges, paired
FG(RGBA)/BG frames through frame_corr.json, quantized flow PNGs (/100,
NaN-invalid), padded to the network's shape (the reference's precomputed
val path). Items are float32 ``[S, H, W, C]`` in BGR 0-255, as the JAX
package yields them; :func:`make_loader` batches them with
``torch.utils.data.DataLoader``.

Training items and the val resize path (``resize_bilinear_ac``,
``flow_crop_and_resize``) are not ported: ROADMAP.md Queue 1 item 11.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch.utils.data

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


class VideoMattingDataset(torch.utils.data.Dataset):
    """``mode='val'`` with ``precomputed_val`` (the root the frames are read
    from): items ``dict(a, fg, bg[, wb, wf], idx)`` padded to
    ``image_shape``."""

    def __init__(self, data_root: str, image_shape, mode: str,
                 use_subset: bool = False, no_flow: bool = False,
                 precomputed_val: str | None = None, sample_length: int = 5,
                 plus1: bool = False):
        if mode != "val" or precomputed_val is None:
            raise NotImplementedError(
                "the port reads VideoMatting108 in mode='val' with "
                "precomputed_val only; training items and the val resize "
                "path: ROADMAP.md Queue 1 item 11")
        self.data_root = data_root
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

    def __len__(self):
        return len(self.samples)

    def _read_frame(self, name: str):
        root = self.precomputed_val
        f = imread(os.path.join(root, FG_FOLDER, name), IMREAD_UNCHANGED)
        bgp = os.path.join(root, BG_FOLDER, self.frame_corr[name])
        if not os.path.exists(bgp):
            bgp = os.path.splitext(bgp)[0] + ".png"
        bg = np.float32(imread(bgp, IMREAD_COLOR))
        return np.float32(f[..., :-1]), bg, np.float32(f[..., -1:])

    def __getitem__(self, idx: int):
        sample = self.samples[idx]
        s = len(sample)
        fgs, bgs, alphas = zip(*[self._read_frame(n) for n in sample])
        out = {
            "a": np.stack([self._pad(a, 0.0) for a in alphas]),
            "fg": np.stack([self._pad(f, IMG_PADDING_VALUE) for f in fgs]),
            "bg": np.stack([self._pad(b, IMG_PADDING_VALUE) for b in bgs]),
            "idx": np.int32(idx),
        }
        if not self.no_flow:
            dn = os.path.dirname(sample[0])
            fns = [os.path.splitext(os.path.basename(n))[0] for n in sample]

            def flow(a, b):
                return self._pad(read_flow_png(os.path.join(
                    self.data_root, FLOW_FOLDER, dn, f"flow_{a}_{b}.png")),
                    np.nan)

            nanf = np.full(self.image_shape + [2], np.nan, np.float32)
            wb, wf = [nanf] * s, [nanf] * s
            for i in range(2, s - 2):
                wf[i] = flow(fns[i], fns[i + 1])
                wb[i] = flow(fns[i], fns[i - 1])
            wf[1] = flow(fns[1], fns[2])
            wb[-2] = flow(fns[-2], fns[-3])
            out["wb"], out["wf"] = np.stack(wb), np.stack(wf)
        return out

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


def stack_collate(items: list[dict]) -> dict:
    """Stack each key's numpy arrays along a new batch axis."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def make_loader(dataset, batch_size: int, num_workers: int = 0
                ) -> torch.utils.data.DataLoader:
    """In-order batches of numpy arrays (the last one may be short), the
    JAX package's ``DataLoader(shuffle=False, drop_last=False)``. Worker
    processes are spawned, not forked: the caller has threads (CUDA's,
    the intra-op pool). Each imports torch and this package before its
    first sample, a start the sweep pays once."""
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=False, drop_last=False,
        num_workers=num_workers, collate_fn=stack_collate,
        multiprocessing_context="spawn" if num_workers else None)
