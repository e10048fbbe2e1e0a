"""Where a ``pred_vmn`` sweep reaches its peak device memory, rank by rank.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m tcvom_tpu_torch.tools.memory_probe --out DIR [--repeat 2] \\
        [--no_tf32] [--no_cudnn] -- <pred_vmn arguments>

(or ``python -m tcvom_tpu_torch.tools.memory_probe ...`` for one
process). The sweep runs ``--repeat`` times in this process, one process
group for all, each from a reset peak. A hook on every module's forward
reads ``torch.cuda.max_memory_allocated`` before and after each call:
each time the running peak has risen by at least 256 MiB since the
last reading, the rise is put down to the call that just ended (or, read
before a call, to the work since the last one ended: an op outside any
module), with the allocated bytes at the call's start and end. A rise
well above what stays allocated at the call's end is memory the call
freed before it returned, a cuDNN workspace for instance. Each rank
writes ``DIR/rank_<r>.json``: per sweep its peak and those rises, and
``torch.cuda.memory_stats``' peaks by pool; and prints one JSON line a
sweep: its peak and its three largest rises. ``--load`` is written first,
from seed 0 (GCA's spectral norms converged), when the file is missing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from tcvom_tpu_torch import parallel

GIB = 2 ** 30
MIN_RISE = 2 ** 28                  # the rises recorded, in bytes


class PeakRecorder:
    """The module forward calls that raised the running peak."""

    def __init__(self, min_bytes: int):
        self.min_bytes, self.names, self.stack = min_bytes, {}, []
        self.events, self.peak = [], 0
        self.last = "start"

    def _name(self, module) -> str:
        if id(module) not in self.names:
            # a call outside every known module names its whole tree
            root = type(module).__name__
            for n, m in module.named_modules():
                self.names.setdefault(id(m), f"{root}.{n}" if n else root)
        return self.names[id(module)]

    def _rose(self, where: str, start: int | None) -> None:
        peak = torch.cuda.max_memory_allocated()
        if peak - self.peak >= self.min_bytes:
            self.events.append({
                "where": where, "peak_gib": peak / GIB,
                "rise_gib": (peak - self.peak) / GIB,
                "start_gib": None if start is None else start / GIB,
                "end_gib": torch.cuda.memory_allocated() / GIB})
        self.peak = max(self.peak, peak)

    def pre(self, module, args):
        name = self._name(module)
        self._rose(f"after {self.last}, before {name}", None)
        self.stack.append(torch.cuda.memory_allocated())

    def post(self, module, args, out):
        name = self._name(module)
        shape = list(out.shape) if torch.is_tensor(out) else None
        self._rose(f"{name} -> {shape}", self.stack.pop())
        self.last = name

    def reset(self) -> None:
        torch.cuda.reset_peak_memory_stats()
        self.names, self.events, self.peak, self.last = {}, [], 0, "start"


def write_checkpoint(model_name: str, agg_window: int, path: str) -> None:
    from tcvom_tpu_torch.models.registry import (build_model,
                                                 converge_spectral_norms)
    from tcvom_tpu_torch.utils.checkpoint import save_weights

    model = build_model(model_name, agg_window=agg_window, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    if model_name.endswith("gca"):
        converge_spectral_norms(model)
    save_weights(model, path)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--no_tf32", action="store_true")
    p.add_argument("--no_cudnn", action="store_true")
    args = p.parse_args(argv[:split])
    run = argv[split + 1:]

    from tcvom_tpu_torch.tools import pred_vmn
    from tcvom_tpu_torch.tools.common import init_ranks

    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = not args.no_cudnn
    os.makedirs(args.out, exist_ok=True)
    rec = PeakRecorder(MIN_RISE)
    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(rec.pre),
             torch.nn.modules.module.register_module_forward_hook(rec.post))
    sweeps, rank = [], 0
    try:
        with init_ranks(pred_vmn.parse_args(run)) as device:
            rank = parallel.rank()
            opts = pred_vmn.parse_args(run)
            if rank == 0 and not os.path.exists(opts.load):
                write_checkpoint("vmn_" + opts.model, opts.agg_window,
                                 opts.load)
            parallel.barrier()
            for i in range(args.repeat):
                rec.reset()
                stats = {}
                pred_vmn.main(run, stats)
                torch.cuda.synchronize(device)
                mem = torch.cuda.memory_stats(device)
                sweeps.append({
                    "sweep": i, "peak_gib": torch.cuda.max_memory_allocated(
                        device) / GIB,
                    "pool_peaks_gib": {
                        k: mem[f"allocated_bytes.{k}.peak"] / GIB
                        for k in ("large_pool", "small_pool")},
                    "step_s": stats["step"], "band": stats.get("band"),
                    "rises": rec.events})
                top = sorted(rec.events, key=lambda e: -e["rise_gib"])[:3]
                print(json.dumps({"rank": rank, **{
                    k: sweeps[-1][k] for k in ("sweep", "peak_gib", "band")},
                    "top_rises": top}), flush=True)
    finally:
        for h in hooks:
            h.remove()
    with open(os.path.join(args.out, f"rank_{rank}.json"), "w") as f:
        json.dump({"no_cudnn": args.no_cudnn, "no_tf32": args.no_tf32,
                   "sweeps": sweeps}, f, indent=1)


if __name__ == "__main__":
    main()
