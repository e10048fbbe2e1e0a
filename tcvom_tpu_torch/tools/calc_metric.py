"""Offline metric calculator (port of tools/calc_metric.py).

Discovers the fully predicted videos from frame_corr.json, computes
SAD/MSE/SSDA per frame and dtSSD/MESSDdt against the next frame through the
quantized flow PNGs, and writes the nested per-frame / per-video / global
metric.json. PNGs are decoded on host threads; the metrics run on
``--device`` (the card by default). ``--vis`` also writes each frame's
error overlay | gt with its trimap and its numbers under ``<pred>/vis/``
(it needs OpenCV).

    python -m tcvom_tpu_torch.tools.calc_metric --pred out/ --data VMD108/ \
        [--vis] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tcvom_tpu_torch.data.augment import need_cv2
from tcvom_tpu_torch.data.vmd import read_flow_png
from tcvom_tpu_torch.ops.metrics import frame_metrics
from tcvom_tpu_torch.utils.device import resolve_device
from tcvom_tpu_torch.utils.imageio import (IMREAD_GRAYSCALE, IMREAD_UNCHANGED,
                                           imread)
from tcvom_tpu_torch.utils.visualize import write_error_vis

METRIC_KEYS = ["mSAD", "MSE", "SSDA", "dtSSD", "MESSDdt_fix", "MESSDdt"]


def discover_frames(pred_dir: str, data_dir: str):
    """Videos with every frame predicted, then (cur, next-or-'') pairs
    (reference calc_metric.py:131-176)."""
    with open(os.path.join(data_dir, "frame_corr.json")) as f:
        fdict = json.load(f)
    exists = {}
    for fkey in sorted(fdict):
        fn = os.path.splitext(fkey)[0]
        exists[fkey] = all(os.path.exists(os.path.join(pred_dir, fn + sfx))
                           for sfx in ("_pred.png", "_tri.png"))
    videos, current, full = [], "", True
    for fkey in sorted(fdict):
        d = os.path.dirname(fkey)
        if d != current:
            if full and current:
                videos.append(current)
            current, full = d, True
        if not exists[fkey]:
            full = False
    if full and current:
        videos.append(current)
    frames = [f for f in sorted(exists) if exists[f]
              and os.path.dirname(f) in set(videos)]
    pairs = []
    for i, cf in enumerate(frames):
        nf = frames[i + 1] if i + 1 < len(frames) else ""
        if nf and os.path.dirname(nf) != os.path.dirname(cf):
            nf = ""
        pairs.append((cf, nf))
    return videos, pairs


def read_frame(pred_dir, data_dir, fkey):
    """(pred alpha in [0, 1], trimap 0..255, gt alpha in [0, 1]), f32."""
    fn = os.path.splitext(fkey)[0]
    a = imread(os.path.join(pred_dir, fn + "_pred.png"), IMREAD_GRAYSCALE)
    t = imread(os.path.join(pred_dir, fn + "_tri.png"), IMREAD_GRAYSCALE)
    g = imread(os.path.join(data_dir, "FG_done", fkey),
               IMREAD_UNCHANGED)[..., -1]
    return np.float32(a) / 255.0, np.float32(t), np.float32(g) / 255.0


def load_pair(pred_dir, data_dir, pair):
    """One frame's ``frame_metrics`` arguments, as numpy."""
    cf, nf = pair
    a, t, g = read_frame(pred_dir, data_dir, cf)
    if nf:
        ha, _, hg = read_frame(pred_dir, data_dir, nf)
        cb, nb = (os.path.splitext(os.path.basename(f))[0] for f in pair)
        flow = read_flow_png(os.path.join(data_dir, "flow_png",
                                          os.path.dirname(cf),
                                          f"flow_{cb}_{nb}.png"))
        hvalid = np.float32(1.0)
    else:
        ha, hg = np.zeros_like(a), np.zeros_like(g)
        flow = np.full(a.shape + (2,), np.nan, np.float32)
        hvalid = np.float32(0.0)
    return a, g, t, ha, hg, hvalid, flow


def aggregate(videos, results: dict) -> dict:
    """Per video, then over videos (calc_metric.py:190-233)."""
    agg = {"avg": {}, "all": {}}
    allres = dict.fromkeys(METRIC_KEYS, 0.0)
    for v in videos:
        vres = dict.fromkeys(METRIC_KEYS, 0.0)
        vres.update(pixel_count=0, flow_pixel_count=0)
        frames_v = {cf: m for cf, m in results.items()
                    if os.path.dirname(cf) == v}
        for m in frames_v.values():
            for k in vres:
                vres[k] += m[k]
        for k in METRIC_KEYS:
            vres[k] /= float(max(len(frames_v), 1))
            allres[k] += vres[k]
        agg["all"][v] = {"avg": vres, "all": frames_v}
    for k in METRIC_KEYS:
        allres[k] /= float(max(len(videos), 1))
    agg["avg"] = allres
    return agg


def main(argv=None) -> dict:
    """Writes metric.json; returns its contents."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pred", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--vis", action="store_true",
                   help="write per-frame error visualizations (red error "
                        "overlay | gt, trimap inset, SAD / MSE caption) "
                        "under <pred>/vis (needs OpenCV)")
    p.add_argument("--n_threads", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device of the metrics (default: the card)")
    args = p.parse_args(argv)
    if args.vis:
        need_cv2("--vis")
    dev = resolve_device(args.device)

    videos, pairs = discover_frames(args.pred, args.data)
    print("Present videos:", videos)
    results = {}
    with ThreadPoolExecutor(args.n_threads) as ex:
        loads = ex.map(lambda pr: load_pair(args.pred, args.data, pr), pairs)
        for (cf, _), arrs in zip(pairs, loads):
            out = frame_metrics(*[torch.as_tensor(x, device=dev)
                                  for x in arrs])
            m = results[cf] = {k: float(v) for k, v in out.items()}
            if args.vis:
                a, g, t = arrs[:3]
                write_error_vis(os.path.join(args.pred, "vis"), cf, a, g, t,
                                m["mSAD"], m["MSE"], int(m["pixel_count"]))
            print(cf)

    agg = aggregate(videos, results)
    output = args.output or os.path.join(args.pred, "metric.json")
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "w") as f:
        json.dump(agg, f, indent=4, sort_keys=True)
    print(json.dumps(agg["avg"], indent=2))
    return agg


if __name__ == "__main__":
    main()
