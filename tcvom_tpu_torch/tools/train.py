"""Training (port of tools/train.py: the reference's train_ddp.py,
train_single_ddp.py and pretrain_ddp.py), for any of the
``cfgs/*.yaml``, on one card:

    python -m tcvom_tpu_torch.tools.train --cfg cfgs/<name>.yaml \\
        [--driver vmd|single] [--dataset vmd|dim] [--sample_length N] \\
        [--eps E] [--device cuda|cpu] [KEY VALUE ...]

or data-parallel, one process a rank, under ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tcvom_tpu_torch.tools.train --cfg cfgs/<name>.yaml \\
        [--dist_backend nccl|gloo] [... as above]

Each rank trains on ``TRAIN.BATCH_SIZE_PER_GPU`` samples of a global batch
of that times N (the sharded loader, ``data/loader.py``) and a step is the
one-process step on the global batch (``train/trainer.py``); the
epoch has the per-rank loader's length. The ranks take the cards
``LOCAL_RANK`` mod the count over NCCL; two ranks on one card need
``--dist_backend gloo`` (NCCL refuses them). Rank 0 alone writes the log
``<cfg>_<time>_train.log``, the image grids, the checkpoints,
``best.pth`` and ``train_stats.json``; rank r > 0 logs to
``..._train_p<r>.log``. ``--device cpu`` trains the ranks on the CPU over
gloo.

The model and its optimizer from the config, the weights staged as in the
JAX tool (``TRAIN.LOAD_IMAGENET``, then ``LOAD_CKPT`` (a ``.pth``), then
``LOAD_OPT``, a train state to resume from: its epoch is ``step //
steps_per_epoch``), then the epochs: a log line every ``PRINT_FREQ``
steps, image grids every ``IMAGE_FREQ``, validation L_dt from epoch
``VAL_FROM_EPOCH`` (video trainer), a train state
``checkpoint_<epoch>.pth`` after each epoch and ``best.pth`` (weights)
when validation improves, all under ``<OUTDIR>/<cfg name><EXP_SUFFIX>/``;
every rank loads the same weights and train state. It runs on the card
unless ``--device cpu`` is given, in f32 (``TRAIN.BF16`` is refused).
The JAX tool's ``--remat`` is not ported (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.config import load_config
from tcvom_tpu_torch.data.loader import make_loader
from tcvom_tpu_torch.data.vmd import VideoMattingDataset
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.ops import cuda_build
from tcvom_tpu_torch.tools.common import add_device_arg, init_ranks
from tcvom_tpu_torch.train.trainer import MattingTrainer
from tcvom_tpu_torch.utils.checkpoint import (load_imagenet_encoder,
                                              load_weights,
                                              restore_train_state,
                                              save_train_state, save_weights)
from tcvom_tpu_torch.utils.logging import AverageMeter, create_logger
from tcvom_tpu_torch.utils.visualize import (write_training_images,
                                             write_val_triplets)

# the reference validates from epoch 15 on (train_ddp.py:322)
VAL_FROM_EPOCH = 15
# the steps the profiler traces in the first epoch (--profile_dir)
PROFILE_STEPS = (10, 20)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", required=True)
    p.add_argument("--driver", default="vmd", choices=["vmd", "single"],
                   help="'vmd' = video trainer (train_ddp), 'single' = "
                        "single-frame/pretrain trainer")
    p.add_argument("--dataset", default="vmd", choices=["vmd", "dim"],
                   help="'dim' selects the Adobe pretrain dataset")
    p.add_argument("--sample_length", type=int, default=None)
    p.add_argument("--eps", type=float, default=0.0,
                   help="alpha snapping for pretrain (1e-2 in pretrain_ddp)")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic algorithms where torch has them "
                        "(torch.use_deterministic_algorithms, warn_only): "
                        "a rerun takes the same steps up to the ops that "
                        "have none")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 10-20 here")
    p.add_argument("--val_image_batches", type=int, default=2,
                   help="val batches to dump as pred/tri/gt PNG triplets "
                        "per epoch (reference train_ddp.py:129-138)")
    add_device_arg(p, distributed=True)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def _datasets(cfg, args, seed: int):
    """(train, val or None) of ``--dataset``."""
    if args.dataset == "dim":
        from tcvom_tpu_torch.data.dim import DIMPretrainDataset
        return DIMPretrainDataset(
            cfg.DATASET.PATH, cfg.TRAIN.TRAIN_INPUT_SIZE,
            min_shape=cfg.TRAIN.MIN_EDGE_LENGTH, plus1=False, seed=seed), None
    sample_length = args.sample_length or (5 if args.driver == "vmd" else 3)
    plus1 = cfg.MODEL.startswith("vmn_res")
    train = VideoMattingDataset(
        cfg.DATASET.PATH, cfg.TRAIN.TRAIN_INPUT_SIZE, "train",
        use_subset=cfg.DATASET.SUBSET, no_flow=True,
        sample_length=sample_length, plus1=plus1, seed=seed)
    val = VideoMattingDataset(
        cfg.DATASET.PATH, cfg.TRAIN.VAL_INPUT_SIZE, "val",
        use_subset=cfg.DATASET.SUBSET, no_flow=True, sample_length=3,
        plus1=plus1, seed=seed)
    return train, val


def _on(batch: dict, device) -> dict:
    return {k: torch.from_numpy(batch[k]).to(device) for k in
            ("a", "fg", "bg")}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; returns the run's timing (also written to
    ``train_stats.json`` in the output folder by rank 0): ``steps`` taken,
    ``setup_s`` (config to the first epoch), ``step_s`` (mean seconds a
    step, ending in a device synchronize; ``first_step_s`` the first's,
    ``later_step_s`` the mean of the others), ``load_wait_s`` (mean
    seconds a step waited on the loader), the last ``step``, the
    ``ranks`` and their ``backend`` (None without a process group), this
    process's kernel ``launches`` by name (``val_launches`` those of the
    validations among them) and, on the card, its
    ``max_memory_allocated_gib``. Under ``torch.distributed.run`` the
    process group lives as long as the call."""
    args = build_argparser().parse_args(argv)
    t_setup = time.perf_counter()
    cfg = load_config(args.cfg, args.opts)
    if cfg.TRAIN.BF16:
        raise ValueError(
            "TRAIN.BF16: bf16 training is experimental in the JAX package "
            "(BF16_TRAIN_GUARD.json: all_ok false) and not ported; the port "
            "trains in f32 (ROADMAP.md Queue 1 item 11)")
    if args.deterministic:
        # cuBLAS reads its workspace setting when it starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    with init_ranks(args) as device:
        return _train(args, cfg, device, t_setup)


def _train(args, cfg, device, t_setup: float) -> dict:
    rank, ranks = parallel.rank(), parallel.world()
    lead = rank == 0
    cfg_name = (os.path.splitext(os.path.basename(args.cfg))[0]
                + cfg.SYSTEM.EXP_SUFFIX)
    logger, outdir = create_logger(cfg.SYSTEM.OUTDIR, cfg_name,
                                   "train" if lead else f"train_p{rank}")
    if lead:
        cfg.dump(os.path.join(outdir, "config.yaml"))
    logger.info("config:\n%s", cfg)
    logger.info("device: %s, rank %d of %d", torch.cuda.get_device_name(
        device) if device.type == "cuda" else "cpu", rank, ranks)

    seed = cfg.SYSTEM.RANDOM_SEED if cfg.SYSTEM.RANDOM_SEED > 0 else 0
    train_ds, val_ds = _datasets(cfg, args, seed)
    bs = cfg.TRAIN.BATCH_SIZE_PER_GPU
    train_loader = make_loader(train_ds, bs, cfg.SYSTEM.NUM_WORKERS,
                               shuffle=True, seed=seed, drop_last=True,
                               num_shards=ranks, shard=rank)
    steps_per_epoch = len(train_loader)
    total_iters = cfg.TRAIN.TOTAL_STEPS * steps_per_epoch

    task = TaskConfig(model=cfg.MODEL, agg_window=cfg.AGG_WINDOW,
                      freeze_backbone=cfg.TRAIN.FREEZE_BACKBONE, eps=args.eps)
    trainer = MattingTrainer(task, args.driver, optimizer=cfg.TRAIN.OPTIMIZER,
                             lr_strategy=cfg.TRAIN.LR_STRATEGY,
                             base_lr=cfg.TRAIN.BASE_LR,
                             weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                             total_iters=total_iters, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(seed))

    start_epoch = 0
    if cfg.TRAIN.LOAD_IMAGENET:
        # before LOAD_CKPT, so that a staged checkpoint can still override
        load_imagenet_encoder(state.model, cfg.TRAIN.LOAD_IMAGENET, logger)
        logger.info("=> loaded ImageNet pretrain weight from %s",
                    cfg.TRAIN.LOAD_IMAGENET)
    if cfg.TRAIN.LOAD_CKPT:
        load_weights(state.model, cfg.TRAIN.LOAD_CKPT, logger)
        logger.info("=> loaded checkpoint from %s", cfg.TRAIN.LOAD_CKPT)
    if cfg.TRAIN.LOAD_OPT:
        restore_train_state(cfg.TRAIN.LOAD_OPT, state)
        start_epoch = state.step // steps_per_epoch
        logger.info("=> resumed full train state from %s (step %d, epoch "
                    "%d)", cfg.TRAIN.LOAD_OPT, state.step, start_epoch)

    losses_fmt = (["L_alpha", "L_comp", "L_grad"] if task.method != "fba"
                  else ["L_alpha_comp", "L_lap", "L_grad"])
    best_loss = 1e8
    stats = {"steps": 0, "setup_s": time.perf_counter() - t_setup,
             "step_s": 0.0, "load_wait_s": 0.0, "ranks": ranks,
             "val_launches": {}}
    tic0 = time.time()
    for epoch in range(start_epoch, cfg.TRAIN.TOTAL_STEPS):
        train_loader.sampler.set_epoch(epoch)
        batch_time, ave_loss = AverageMeter(), AverageMeter()
        tic = time.time()
        prof = None
        t_wait = time.perf_counter()
        for i_iter, batch in enumerate(train_loader):
            t_step = time.perf_counter()
            stats["load_wait_s"] += t_step - t_wait
            if args.profile_dir and epoch == start_epoch:
                if i_iter == PROFILE_STEPS[0]:
                    prof = _start_profiler(device)
                elif i_iter == PROFILE_STEPS[1] and prof is not None:
                    _stop_profiler(prof, args.profile_dir, logger)
                    prof = None
            dev_batch = _on(batch, device)
            state, metrics = trainer.train_step(state, dev_batch)
            _sync(device)
            secs = time.perf_counter() - t_step
            stats["step_s"] += secs
            if stats["steps"] == 0:
                stats["first_step_s"] = secs
            stats["steps"] += 1
            if i_iter % cfg.TRAIN.PRINT_FREQ == 0:
                ave_loss.update(metrics["loss"].item())
                batch_time.update(time.time() - tic)
                tic = time.time()
                cur = epoch * steps_per_epoch + i_iter
                msg = (f"Iter:[{cur}/{total_iters}], Time: "
                       f"{batch_time.average() / max(cfg.TRAIN.PRINT_FREQ, 1):.2f}, "
                       f"lr: {metrics['lr']:.6g}, "
                       f"Avg. Loss: {ave_loss.average():.6f} | "
                       f"Current: Loss: {metrics['loss'].item():.6f}, ")
                msg += " ".join(f"{n}: {metrics[k].item():.4f}" for n, k in
                                zip(losses_fmt, ("L1", "L2", "L3")))
                if args.driver == "vmd":
                    msg += (f" L_dt: {metrics['L_dt'].item():.4f}"
                            f" L_att: {metrics['L_att'].item():.4f}")
                logger.info(msg)
            if i_iter % cfg.TRAIN.IMAGE_FREQ == 0:
                # every rank draws the step's radii (and, with ranks, joins
                # the losses' reductions); rank 0 writes its own rows
                aux = trainer.vis_step(state, dev_batch)
                if lead:
                    write_training_images(
                        os.path.join(outdir, "training_images"), aux,
                        epoch * steps_per_epoch + i_iter)
            t_wait = time.perf_counter()
        if prof is not None:
            _stop_profiler(prof, args.profile_dir, logger)

        val_loss = best_loss
        if (val_ds is not None and epoch >= VAL_FROM_EPOCH
                and args.driver == "vmd"):
            before = dict(cuda_build.LAUNCHES)
            val_loss = _validate(trainer, state, val_ds, bs, cfg, args,
                                 os.path.join(outdir, "val_images",
                                              f"epoch_{epoch}"), device)
            for k, v in cuda_build.LAUNCHES.items():
                stats["val_launches"][k] = (stats["val_launches"].get(k, 0)
                                            + v - before.get(k, 0))
            logger.info("epoch %d val L_dt: %.6f", epoch, val_loss)

        # the model itself (not its DDP wrapper), so that the keys are the
        # reference's; the ranks' copies are equal. val_loss is the global
        # batch's on every rank, so all agree on best.pth
        ckpt = os.path.join(outdir, f"checkpoint_{epoch + 1}.pth")
        if lead:
            save_train_state(ckpt, state)
            logger.info("=> saved checkpoint to %s", ckpt)
        parallel.barrier()
        if val_loss < best_loss:
            best_loss = val_loss
            if lead:
                save_weights(state.model, os.path.join(outdir, "best.pth"))
                logger.info("=> new minimum loss. saved best")
            parallel.barrier()
    logger.info("Time: %d sec.", int(time.time() - tic0))
    n = max(stats["steps"], 1)
    if stats["steps"] > 1:
        stats["later_step_s"] = ((stats["step_s"] - stats["first_step_s"])
                                 / (stats["steps"] - 1))
    stats.update(step=state.step, step_s=stats["step_s"] / n,
                 load_wait_s=stats["load_wait_s"] / n,
                 launches=dict(cuda_build.LAUNCHES),
                 backend=parallel.backend())
    if device.type == "cuda":
        stats["max_memory_allocated_gib"] = (
            torch.cuda.max_memory_allocated(device) / 2**30)
    if lead:
        with open(os.path.join(outdir, "train_stats.json"), "w") as f:
            json.dump(stats, f)
    logger.info("Done")
    return stats


def _validate(trainer, state, val_ds, bs: int, cfg, args, img_dir: str,
              device) -> float:
    """Mean validation L_dt over whole global batches
    (train_ddp.py:102-169), the first ``--val_image_batches`` batches'
    center frames of rank 0 written as pred/tri/gt PNG triplets."""
    loader = make_loader(val_ds, bs, cfg.SYSTEM.NUM_WORKERS, drop_last=True,
                         num_shards=parallel.world(), shard=parallel.rank())
    meter, dumped = AverageMeter(), 0
    for bi, batch in enumerate(loader):
        l_dt, (pred_c, tri_c, gt_c) = trainer.val_dt_step(
            state, _on(batch, device))
        meter.update(l_dt.item())
        if bi < args.val_image_batches and parallel.rank() == 0:
            dumped = write_val_triplets(img_dir, pred_c, tri_c, gt_c, dumped)
    return meter.average()


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, logger) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("=> wrote a profiler trace of steps %d-%d to %s",
                *PROFILE_STEPS, path)


if __name__ == "__main__":
    main()
