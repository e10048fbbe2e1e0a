"""Tiny synthetic datasets for smoke tests (port of
tools/make_fake_dataset.py), written as PNG with the port's image writer:

- :func:`make`: a VideoMatting108-format tree: FG_done/<clip>/NNNNN.png
  (RGBA), BG_done pairs, frame_corr.json, train/val video lists, quantized
  flow PNGs (zero flow, all valid);
- :func:`make_wild_folder`: a wild-video folder for pred_test,
  NNNNN_rgb.png / NNNNN_trimap.png;
- :func:`make_adobe`: an Adobe-DIM tree of stills for the TAM pretrain
  (``tools/train.py --dataset dim``); its backgrounds are JPEG files, which
  need OpenCV (cv2).

    python -m tcvom_tpu_torch.tools.make_fake_dataset --root DIR \
        [--wild | --adobe N]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from tcvom_tpu_torch.utils.imageio import imwrite


def make(root: str, clips=("clip_a", "clip_b"), frames=6, hw=(1080, 1920),
         seed=0):
    """The JAX package's tree, draw for draw from ``seed``: the first clip
    is listed for training, the others for validation."""
    rng = np.random.RandomState(seed)
    h, w = hw
    frame_corr = {}
    yy, xx = np.mgrid[0:h, 0:w]
    for clip in clips:
        for sub in ("FG_done", "BG_done", "flow_png"):
            os.makedirs(os.path.join(root, sub, clip), exist_ok=True)
        cx, cy = rng.randint(w // 4, 3 * w // 4), rng.randint(h // 4, 3 * h // 4)
        for i in range(frames):
            name = f"{i:05d}.png"
            fg = rng.randint(0, 256, (h, w, 3), np.uint8)
            d = np.sqrt((xx - cx - 5 * i) ** 2 + (yy - cy) ** 2)
            # a disc scaled to the frame, so its soft (unknown) ring is
            # always in view
            rad, soft = 0.25 * min(h, w), 0.15 * min(h, w)
            alpha = np.clip((rad - d) / soft + 1.0, 0, 1)
            imwrite(os.path.join(root, "FG_done", clip, name),
                    np.concatenate([fg, np.uint8(alpha[..., None] * 255)], -1))
            imwrite(os.path.join(root, "BG_done", clip, name),
                    rng.randint(0, 256, (h, w, 3), np.uint8))
            frame_corr[f"{clip}/{name}"] = f"{clip}/{name}"
        # zero flow, valid everywhere, for consecutive pairs (both ways)
        flow = np.zeros((h, w, 3), np.uint16)
        flow[..., 2] = 255
        for i in range(frames - 1):
            a, b = f"{i:05d}", f"{i + 1:05d}"
            for x, y in ((a, b), (b, a)):
                imwrite(os.path.join(root, "flow_png", clip,
                                     f"flow_{x}_{y}.png"), flow)
    with open(os.path.join(root, "frame_corr.json"), "w") as f:
        json.dump(frame_corr, f)
    for mode, vids in (("train", clips[:1]), ("val", clips[1:])):
        for fmt in ("{}_videos.txt", "{}_videos_subset.txt"):
            with open(os.path.join(root, fmt.format(mode)), "w") as f:
                f.write("\n".join(vids) + "\n")


def make_wild_folder(root: str, frames: int = 3, hw=(60, 90), seed=0):
    """NNNNN_rgb.png (noise) and NNNNN_trimap.png: an unknown band (128)
    around a foreground core (255), both moving a pixel a frame."""
    rng = np.random.RandomState(seed)
    h, w = hw
    os.makedirs(root, exist_ok=True)
    for i in range(frames):
        imwrite(os.path.join(root, f"{i:05d}_rgb.png"),
                rng.randint(0, 256, (h, w, 3), np.uint8))
        tri = np.zeros((h, w), np.uint8)
        tri[int(0.28 * h) + i:int(0.74 * h) + i,
            int(0.26 * w):int(0.73 * w)] = 128
        tri[int(0.42 * h) + i:int(0.6 * h) + i,
            int(0.36 * w):int(0.63 * w)] = 255
        imwrite(os.path.join(root, f"{i:05d}_trimap.png"), tri)


def make_adobe(root: str, n: int = 2, hw=(80, 56), seed=0):
    """The JAX package's tiny Adobe-DIM tree (reference dataset/DIM.py
    layout), draw for draw from ``seed``: stills of growing size, a disc
    alpha, JPEG backgrounds twice as large; ``fg_val_set.txt`` and
    ``fg_train_set_old.txt`` list '<fg> <alpha>', ``bg_val_set.txt`` and
    ``bg_train_set.txt`` one background a line."""
    rng = np.random.RandomState(seed)
    for d in ("fg", "alpha", "bg"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    fg_lines, bg_lines = [], []
    for i in range(n):
        h, w = hw[0] + 8 * i, hw[1] + 4 * i
        fg = rng.randint(0, 256, (h, w, 3), np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        d = np.sqrt((xx - w / 2) ** 2 + (yy - h / 2) ** 2)
        alpha = np.uint8(np.clip((0.3 * min(h, w) - d) / (0.2 * min(h, w))
                                 + 1.0, 0, 1) * 255)
        bg = rng.randint(0, 256, (h * 2, w * 2, 3), np.uint8)
        imwrite(os.path.join(root, "fg", f"{i}.png"), fg)
        imwrite(os.path.join(root, "alpha", f"{i}.png"), alpha)
        imwrite(os.path.join(root, "bg", f"{i}.jpg"), bg)
        fg_lines.append(f"fg/{i}.png alpha/{i}.png")
        bg_lines.append(f"bg/{i}.jpg")
    for name, lines in (("fg_val_set.txt", fg_lines),
                        ("bg_val_set.txt", bg_lines),
                        ("fg_train_set_old.txt", fg_lines),
                        ("bg_train_set.txt", bg_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--wild", action="store_true",
                   help="write a pred_test folder instead of a "
                        "VideoMatting108 tree")
    p.add_argument("--adobe", type=int, default=0, metavar="N",
                   help="write an Adobe-DIM tree of N stills (sizes from "
                        "--height and --width) instead")
    a = p.parse_args()
    if a.wild:
        make_wild_folder(a.root, a.frames, (a.height, a.width))
    elif a.adobe:
        make_adobe(a.root, a.adobe, (a.height, a.width))
    else:
        make(a.root, frames=a.frames, hw=(a.height, a.width))
    print("fake dataset at", a.root)
