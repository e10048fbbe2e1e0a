"""Wild-video inference from real trimaps (port of tools/pred_test.py):
folders of NNNNN_rgb.png / NNNNN_trimap.png -> NNNNN_alpha.png.

    python -m tcvom_tpu_torch.tools.pred_test --model fba --vmn \
        --load ckpt.pth --data frames/ --save out/ [--bf16] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os

import torch

from tcvom_tpu_torch.infer.predict import predict_test_folder
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.tools.common import MODELS, add_device_arg, load_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, choices=MODELS)
    p.add_argument("--vmn", action="store_true",
                   help="use the VMN temporal model (default single-frame)")
    p.add_argument("--load", required=True, help="checkpoint (.pth)")
    p.add_argument("--data", required=True,
                   help="a frame folder, or a root of per-video folders")
    p.add_argument("--save", required=True, help="output folder")
    p.add_argument("--agg_window", type=int, default=7)
    p.add_argument("--dilation", type=int, default=None,
                   help="extra unknown-region dilation radius applied to "
                        "the provided trimaps (reference pred_test.py:149)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute on the streaming (VMN) path")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process this process's static 1/N slice of the "
                        "video list, e.g. --shard 0/4 .. 3/4, one process "
                        "per card (reference pred_test.py:124-137)")
    p.add_argument("videos", nargs="*",
                   help="video subfolders of --data to process (default: "
                        "all, or --data itself if it holds frames directly)")
    add_device_arg(p)
    return p.parse_args(argv)


def find_runs(data: str, save: str, videos=()) -> list[tuple[str, str]]:
    """(input, output) folder pairs: the named videos, --data itself if it
    holds frames, else every subfolder (reference pred_test.py:19-29)."""
    if videos:
        return [(os.path.join(data, v), os.path.join(save, v)) for v in videos]
    if glob.glob(os.path.join(data, "*_rgb.png")):
        return [(data, save)]
    vids = sorted(d for d in os.listdir(data)
                  if os.path.isdir(os.path.join(data, d)))
    return [(os.path.join(data, v), os.path.join(save, v)) for v in vids]


def shard_runs(runs: list, shard: str) -> list:
    """The contiguous slice I of N: video v goes to shard i iff
    i*len//n <= v < (i+1)*len//n (reference pred_test.py:124-137)."""
    try:
        i, n = (int(x) for x in shard.split("/"))
        if not 0 <= i < n:
            raise ValueError
    except ValueError:
        raise SystemExit(f"--shard must be I/N with 0<=I<N, got {shard!r}")
    lo, hi = i * len(runs) // n, (i + 1) * len(runs) // n
    print(f"shard {i}/{n}: videos [{lo}:{hi}] of {len(runs)}")
    return runs[lo:hi]


def main(argv=None) -> list[dict]:
    """Runs every selected folder; returns each run's stats."""
    args = parse_args(argv)
    name = ("vmn_" + args.model) if args.vmn else args.model
    cfg = TaskConfig(model=name, agg_window=args.agg_window,
                     dilate_radius=args.dilation)
    runs = find_runs(args.data, args.save, args.videos)
    if not runs:
        raise SystemExit(f"no videos found under {args.data}")
    if args.shard:
        runs = shard_runs(runs, args.shard)
        if not runs:
            return []
    model = load_model(name, args, args.agg_window)
    stats = []
    for in_dir, out_dir in runs:
        print(f"== {in_dir} -> {out_dir}")
        stats.append(predict_test_folder(
            model, cfg, in_dir, out_dir,
            progress=lambda i, n: print(f"{i + 1}/{n}"),
            dtype=torch.bfloat16 if args.bf16 else None, device=args.device))
    return stats


if __name__ == "__main__":
    main()
