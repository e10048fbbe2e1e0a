"""Single-frame baseline inference (port of tools/pred_single.py): the
single-frame model on the center frame of each VideoMatting108 val sample,
or of each Adobe-DIM still's synthesized frames (``--dataset adobe``,
brought to the grid by ``--val_mode``), with trimaps synthesized at a
fixed width; writes pred/tri PNGs and prints the mean SAD / MSE over the
unknown region. ``--vis`` also writes each sample's pred | gt with its
trimap and its numbers under ``<save>/vis/`` (it needs OpenCV).

    python -m tcvom_tpu_torch.tools.pred_single --model fba --data VMD108/ \
        --load ckpt.pth --trimap medium --save out/ [--device cpu]
    python -m tcvom_tpu_torch.tools.pred_single --model fba --data Adobe/ \
        --dataset adobe [--val_mode resize --min_shape 800] --load ckpt.pth \
        --trimap medium --save out/ [--vis] [--device cpu]

Under ``python -m torch.distributed.run --nproc_per_node N`` each rank
reads every N-th batch and writes its own PNGs, the files of a
one-process sweep; mSAD and MSE are taken over every rank's samples, and
rank 0 writes loss.log once every rank is done (``--dist_backend gloo``
for two ranks on one card).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.data.augment import need_cv2
from tcvom_tpu_torch.data.dim import DIMEvalDataset
from tcvom_tpu_torch.data.loader import make_loader
from tcvom_tpu_torch.data.vmd import VideoMattingDataset
from tcvom_tpu_torch.infer.predict import (TRIMAP_DILATION,
                                           make_single_eval_step,
                                           write_pred_pngs)
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.tools.common import (MODELS, add_device_arg, init_ranks,
                                          load_model)
from tcvom_tpu_torch.tools.pred_vmn import default_save
from tcvom_tpu_torch.utils.logging import print_loss_dict
from tcvom_tpu_torch.utils.visualize import write_vis_image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, choices=MODELS)
    p.add_argument("--data", required=True)
    p.add_argument("--load", required=True, help="checkpoint (.pth)")
    p.add_argument("--n_threads", type=int, default=8,
                   help="DataLoader worker processes")
    p.add_argument("--subset", action="store_true")
    p.add_argument("--save", default=None)
    p.add_argument("--trimap", required=True, choices=list(TRIMAP_DILATION))
    p.add_argument("--image_shape", type=int, nargs=2, default=(1088, 1920))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dataset", default="vmd", choices=["vmd", "adobe"],
                   help="'adobe' evaluates on the DIM still-image set "
                        "(fg_val_set.txt, bg_val_set.txt)")
    p.add_argument("--val_mode", default="resize",
                   choices=["gca", "dim", "origin", "resize"],
                   help="Adobe resizing (with --dataset adobe)")
    p.add_argument("--min_shape", type=int, default=800,
                   help="Adobe resizing (with --dataset adobe)")
    p.add_argument("--vis", action="store_true",
                   help="write pred | gt with a trimap inset and the "
                        "sample's SAD / MSE caption under <save>/vis "
                        "(needs OpenCV)")
    add_device_arg(p, distributed=True)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """The sweep; returns the mean SAD and MSE written to loss.log."""
    args = parse_args(argv)
    if args.vis:
        need_cv2("--vis")
    with init_ranks(args):
        return _sweep(args)


def _sweep(args) -> dict:
    args.save = args.save or default_save("single", args)
    os.makedirs(args.save, exist_ok=True)

    cfg = TaskConfig(model=args.model,
                     dilate_radius=TRIMAP_DILATION[args.trimap])
    if args.dataset == "adobe":
        dataset = DIMEvalDataset(data_root=args.data, val_mode=args.val_mode,
                                 min_shape=args.min_shape, plus1=False)
    else:
        dataset = VideoMattingDataset(
            data_root=args.data, image_shape=tuple(args.image_shape),
            mode="val", use_subset=args.subset, plus1=False,
            precomputed_val=args.data, sample_length=3, no_flow=True)
    loader = make_loader(dataset, args.batch, args.n_threads,
                         num_shards=parallel.world(), shard=parallel.rank())
    model = load_model(args.model, args)
    step = make_single_eval_step(model, cfg)

    c = dataset.sample_length // 2
    msad, mse, count = 0.0, 0.0, 0
    for batch in loader:
        _, alphas, tris = step(batch)
        alphas, tris = alphas.cpu().numpy(), tris.cpu().numpy()
        gts = batch["a"][:, c] / 255.0
        per_sample = []                   # (SAD, MSE, unknown pixels)
        for i in range(alphas.shape[0]):
            t = tris[i, ..., 0]
            m = (t > 0) & (t < 1)
            if m.sum():
                d = alphas[i, ..., 0][m] - gts[i, ..., 0][m]
                per_sample.append((float(np.mean(np.abs(d))),
                                   float(np.mean(d * d)), int(m.sum())))
                msad += per_sample[-1][0]
                mse += per_sample[-1][1]
                count += 1
            else:
                per_sample.append((0.0, 0.0, 0))
        if args.dataset == "adobe":
            # the still's own size cut to the grid, as the JAX tool crops
            # (tools/pred_single.py:135-141): a resized still keeps its
            # padding
            names = ["{:05d}".format(int(i)) for i in batch["idx"]]
            crops = [(int(h), int(w)) for h, w in batch["og_shape"]]
        else:
            names = [dataset.samples[int(i)][c] for i in batch["idx"]]
            crops = [(min(1080, alphas.shape[1]), alphas.shape[2])] * len(
                names)
        write_pred_pngs(args.save, names, alphas, tris, crop_hw=crops)
        if args.vis:
            for i, (name, (h, w)) in enumerate(zip(names, crops)):
                a8, g8, t8 = (np.uint8(np.clip(x[i, :h, :w, 0], 0, 1) * 255)
                              for x in (alphas, gts, tris))
                write_vis_image(os.path.join(args.save, "vis"), name, a8, g8,
                                t8, *per_sample[i])
        print(names[-1])
    msad, mse, count = parallel.all_reduce_sum(torch.tensor(
        [msad, mse, count], dtype=torch.float64,
        device=args.device)).tolist()
    res = {"mSAD": msad / max(count, 1), "MSE": mse / max(count, 1)}
    parallel.barrier()
    if parallel.rank() == 0:
        print_loss_dict(res, os.path.join(args.save, "loss.log"))
    return res


if __name__ == "__main__":
    main()
