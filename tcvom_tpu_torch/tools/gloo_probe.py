"""Which collectives gloo runs on CUDA tensors, and what an ``all_reduce``
costs: the exchange ``pred_vmn --space`` makes for two ranks that share
one card (``parallel/space.py``; NCCL refuses two ranks on one device).

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m tcvom_tpu_torch.tools.gloo_probe

Rank 0 prints one line a collective (``ok`` or the error), then one JSON
line with the versions, the results and the host-clock ms of a 4 KiB and
a 64 MiB ``all_reduce`` (fenced by ``torch.cuda.synchronize``). ``send``
and ``recv`` come last: where gloo takes them on CPU tensors only (torch
2.11.0+cu128: ``writev ... Bad address``), a rank fails or aborts there,
after the JSON line, and the launch exits non-zero.
"""
from __future__ import annotations

import datetime
import json
import os
import time

import torch
import torch.distributed as dist


def main() -> None:
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    res = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except RuntimeError as e:
            res[name] = f"{type(e).__name__}: {str(e)[:150]}"
        if rank == 0:
            print(name, res[name], flush=True)
        dist.barrier()

    def ones(n):
        return torch.ones(n, device=dev)

    attempt("all_reduce", lambda: dist.all_reduce(ones(20)))
    attempt("broadcast", lambda: dist.broadcast(ones(3), 0))
    attempt("all_gather", lambda: dist.all_gather(
        [ones(3) for _ in range(world)], ones(3)))
    attempt("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        ones(3 * world), ones(3)))
    attempt("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        ones(3), ones(3 * world)))
    attempt("all_to_all_single", lambda: dist.all_to_all_single(
        ones(2 * world), ones(2 * world)))
    group = dist.new_group(list(range(world)))
    attempt("all_reduce_subgroup", lambda: dist.all_reduce(ones(2),
                                                            group=group))
    for name, numel, iters in (("4KiB", 1024, 50),
                               ("64MiB", 16 * 1024 * 1024, 5)):
        t = ones(numel)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        res[f"all_reduce_{name}_ms"] = (time.perf_counter() - t0) / iters * 1e3
    if rank == 0:
        print(json.dumps({"torch": torch.__version__,
                          "cuda": torch.version.cuda,
                          "device": torch.cuda.get_device_name(0), **res}),
              flush=True)

    def send_recv():
        if rank == 0:
            dist.send(ones(3), 1)
        elif rank == 1:
            dist.recv(ones(3), 0)

    attempt("send_recv", send_recv)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
