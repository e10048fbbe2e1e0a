"""VideoMatting108 validation inference, full VMN model (port of
tools/pred_vmn.py). Writes <frame>_pred.png / <frame>_tri.png pairs (1080p
crop) and loss.log; feed the output directory to calc_metric.

    python -m tcvom_tpu_torch.tools.pred_vmn --model fba --data VMD108/ \
        --load ckpt.pth --trimap medium --save out/ [--device cpu]

Under ``python -m torch.distributed.run --nproc_per_node N`` (the JAX
tool's sweep over every device) each rank reads every N-th batch of
``--batch`` samples and writes its own PNGs, the files of a one-process
sweep; the losses are summed over the ranks, and rank 0 writes loss.log
once every rank is done. ``--dist_backend gloo`` for two ranks on one
card.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.data.loader import make_loader
from tcvom_tpu_torch.data.vmd import VideoMattingDataset
from tcvom_tpu_torch.infer.predict import (TRIMAP_DILATION, make_vmd_eval_step,
                                           write_pred_pngs)
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.tools.common import (MODELS, add_device_arg, init_ranks,
                                          load_model)
from tcvom_tpu_torch.utils.logging import print_loss_dict

LOSS_NAMES = {"L_alpha": "L1", "L_comp": "L2", "L_grad": "L3",
              "L_dt": "L_dt", "L_att": "L_att"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, choices=MODELS)
    p.add_argument("--data", required=True, help="VideoMatting108 root")
    p.add_argument("--load", required=True, help="checkpoint (.pth)")
    p.add_argument("--n_threads", type=int, default=16,
                   help="DataLoader worker processes")
    p.add_argument("--subset", action="store_true")
    p.add_argument("--save", default=None)
    p.add_argument("--trimap", required=True, choices=list(TRIMAP_DILATION))
    p.add_argument("--agg_window", type=int, default=7)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--image_shape", type=int, nargs=2, default=(1088, 1920),
                   help="padded network resolution (1080 %% 32 != 0)")
    p.add_argument("--space", type=int, default=1,
                   help="split the image H axis over this many cards (not "
                        "ported: ROADMAP.md Queue 1 item 12)")
    add_device_arg(p, distributed=True)
    return p.parse_args(argv)


def default_save(kind: str, args) -> str:
    return "results/{}/{}/{}".format(
        kind + "_subset" if args.subset else kind, args.trimap,
        os.path.splitext(os.path.basename(args.load))[0])


def main(argv=None, stats: dict | None = None) -> dict:
    """The sweep; returns the per-sample mean losses written to loss.log.
    ``stats``, when given, receives the sweep's wall seconds by phase:
    ``setup`` (the dataset, the model and its checkpoint), ``load_wait``
    (starting the loader's workers and waiting on them), ``step`` (the
    evaluation step, its losses read on the host) and ``write`` (the
    mattes read back and their PNGs), this rank's."""
    args = parse_args(argv)
    if args.space != 1:
        raise NotImplementedError("--space splits a frame over several "
                                  "cards: ROADMAP.md Queue 1 item 12")
    with init_ranks(args):
        return _sweep(args, stats)


def _sweep(args, stats: dict | None) -> dict:
    args.save = args.save or default_save("vmd", args)
    os.makedirs(args.save, exist_ok=True)
    stats = {} if stats is None else stats
    stats.update(setup=0.0, load_wait=0.0, step=0.0, write=0.0)

    def lap(key, t0):
        stats[key] += time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    model_name = "vmn_" + args.model
    cfg = TaskConfig(model=model_name, agg_window=args.agg_window,
                     dilate_radius=TRIMAP_DILATION[args.trimap])
    dataset = VideoMattingDataset(
        data_root=args.data, image_shape=tuple(args.image_shape), mode="val",
        use_subset=args.subset, plus1=False, precomputed_val=args.data,
        sample_length=3, no_flow=True)
    loader = make_loader(dataset, args.batch, args.n_threads,
                         num_shards=parallel.world(), shard=parallel.rank())
    model = load_model(model_name, args, args.agg_window)
    step = make_vmd_eval_step(model, cfg)

    c = dataset.sample_length // 2
    crop = (min(1080, args.image_shape[0]), min(1920, args.image_shape[1]))
    eval_loss = dict.fromkeys(list(LOSS_NAMES) + ["L_total"], 0.0)
    t0 = lap("setup", t0)
    batches = iter(loader)
    while (batch := next(batches, None)) is not None:
        t0 = lap("load_wait", t0)
        losses, alphas, tris = step(batch)
        losses = {k: float(v) for k, v in losses.items()}
        t0 = lap("step", t0)
        b = len(batch["idx"])
        for name, k in LOSS_NAMES.items():
            eval_loss[name] += losses[k] * b
        eval_loss["L_total"] += sum(losses.values()) * b
        names = [dataset.samples[int(i)][c] for i in batch["idx"]]
        write_pred_pngs(args.save, names, alphas, tris, crop_hw=crop)
        print(f"{names[-1]}  " + " ".join(f"{k}={v:.4f}"
                                          for k, v in losses.items()))
        t0 = lap("write", t0)
    lap("load_wait", t0)
    sums = parallel.all_reduce_sum(torch.tensor(
        list(eval_loss.values()), dtype=torch.float64, device=args.device))
    eval_loss = {k: float(v) / float(len(dataset))
                 for k, v in zip(eval_loss, sums.tolist())}
    parallel.barrier()
    if parallel.rank() == 0:
        print_loss_dict(eval_loss, os.path.join(args.save, "loss.log"))
    return eval_loss


if __name__ == "__main__":
    main()
