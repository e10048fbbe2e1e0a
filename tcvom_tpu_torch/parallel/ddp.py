"""One process per rank under ``python -m torch.distributed.run`` (the
port's counterpart of tcvom_tpu/parallel/mesh.py; the reference's
train_ddp.py:199-204, 270-280).

Under GSPMD the JAX package computes the one-device step on the global
batch. Here each rank holds its slice of that batch and:

- gradients are averaged by DDP (:func:`wrap`);
- BatchNorm reduces its statistics over every rank
  (``models/layers.py::BatchNorm``, through :func:`all_reduce_sum_grad`);
- a loss whose normalizer is a count over the batch takes the count over
  every rank (:func:`all_reduce_sum`) and scales its own numerator by
  :func:`world`, so that DDP's mean of the ranks' gradients is the
  gradient of the global-batch loss (``ops/losses.py``, ``global_batch``);
- per-sample randomness is drawn at the global batch's size from a
  generator every rank seeds alike, and each rank keeps its rows
  (:func:`shard_slice`).

Without a process group (a plain ``python`` run) every helper is the
one-process identity: :func:`world` is 1 and :func:`rank` 0.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def init_from_env(device: str | torch.device = "cuda",
                  backend: str | None = None,
                  init_method: str = "env://") -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes in
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and ``MASTER_ADDR``,
    ``MASTER_PORT`` for ``env://``), and return this rank's device: on the
    card ``cuda:<LOCAL_RANK % device count>`` (so that two ranks can share
    one card), else the CPU.

    ``backend``: NCCL on the card and gloo on the CPU by default; gloo on
    the card when asked (NCCL refuses two ranks on one device). Without
    ``WORLD_SIZE`` in the environment nothing is initialized and
    ``device`` is returned as it is: a plain one-process run. A group
    that fails to start raises; nothing falls back to one process."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    world_size = int(os.environ["WORLD_SIZE"])
    rank_ = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank_,
            world_size=world_size, timeout=datetime.timedelta(minutes=30))
    return dev


def is_distributed() -> bool:
    """Whether this process is a rank of a process group (of any size)."""
    return dist.is_initialized()


def backend() -> str | None:
    """The process group's backend ("nccl", "gloo"), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def world() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, without gradient (counts, logged
    values); ``t`` itself (detached) with one rank."""
    t = t.detach()
    if world() == 1:
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t)
    return t


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, differentiable: the gradient of
    each rank's input is the sum of every rank's gradient of the result
    (``torch.distributed.nn.functional.all_reduce``). ``t`` with one
    rank."""
    if world() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def shard_slice(global_b: int) -> slice:
    """This rank's rows of a global batch of ``global_b``: the rank's
    contiguous block, as the sharded sampler lays out the batch
    (``data/loader.py::epoch_indices``)."""
    n = world()
    if global_b % n:
        raise ValueError(f"a global batch of {global_b} does not split over "
                         f"{n} ranks")
    b = global_b // n
    return slice(rank() * b, (rank() + 1) * b)


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if world() > 1:
        dist.barrier()


class _DDP(torch.nn.parallel.DistributedDataParallel):
    """DDP that passes the wrapped model's ``frozen_modules()`` through."""

    def frozen_modules(self) -> list[torch.nn.Module]:
        return self.module.frozen_modules()


def wrap(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in DistributedDataParallel over the default process group:
    rank 0's parameters and buffers broadcast once here, the gradients
    averaged over the ranks in the backward pass.

    ``.train()`` reaches the model's own ``train`` (``VMN.train`` keeps a
    frozen backbone in eval) and ``frozen_modules()`` is the model's. Only
    parameters that require a gradient are synchronized: the caller turns
    it off for a frozen backbone first. Every other parameter gets a
    gradient in each step of all eight models, so unused parameters are
    not searched for. Buffers are not broadcast before each forward: the
    BatchNorm statistics and spectral-norm vectors are updated alike on
    every rank (from statistics reduced over all of them, or from the
    weights). The gradients live in DDP's buckets (no second copy)."""
    dev = next(model.parameters()).device
    return _DDP(model, device_ids=[dev.index] if dev.type == "cuda" else None,
                broadcast_buffers=False, gradient_as_bucket_view=True)
