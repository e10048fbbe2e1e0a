"""What the port's CLIs share: the device flag, the ranks of a
``torch.distributed.run`` launch and the model with its weights."""
from __future__ import annotations

import argparse
import contextlib
import re

import torch.distributed as dist

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.models.registry import build_model, method_of
from tcvom_tpu_torch.utils.checkpoint import load_weights, read_state_dict
from tcvom_tpu_torch.utils.device import resolve_device

MODELS = ["gca", "dim", "fba", "index"]
PUBLISHED_LAYERS = (3, 4, 6, 3)


def add_device_arg(p: argparse.ArgumentParser,
                   distributed: bool = False) -> None:
    """``--device``, and with ``distributed`` the process group's
    ``--dist_backend`` under ``torch.distributed.run``."""
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; 'cpu' to run on "
                        "the CPU)")
    if distributed:
        p.add_argument("--dist_backend", default=None,
                       choices=["nccl", "gloo"],
                       help="under torch.distributed.run: NCCL on the card, "
                            "gloo on the CPU (default); gloo for two ranks "
                            "on one card")


@contextlib.contextmanager
def init_ranks(args):
    """This process's device (``args.device`` is set to it): under
    ``torch.distributed.run`` its rank's, in a process group that lives
    until the block ends (``parallel.init_from_env``); otherwise
    ``args.device``."""
    joined = not dist.is_initialized()
    device = resolve_device(parallel.init_from_env(args.device,
                                                   args.dist_backend))
    args.device = str(device)
    try:
        yield device
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def encoder_depth(sd: dict) -> tuple[int, ...]:
    """Blocks per encoder stage of an FBA state_dict (``encoder.layer<i>.<j>.``
    keys, the ResNet's stages); the published depth if it holds none. Only
    FBA's encoder takes a depth: IndexNet's has keys of that form too."""
    blocks = {}
    for k in sd:
        m = re.match(r"encoder\.layer([1-4])\.(\d+)\.", k)
        if m:
            i = int(m.group(1))
            blocks[i] = max(blocks.get(i, 0), int(m.group(2)) + 1)
    if len(blocks) < 4:
        return PUBLISHED_LAYERS
    return tuple(blocks[i] for i in range(1, 5))


def load_model(name: str, args, agg_window: int = 7):
    """``name`` built on ``args.device`` (FBA at the encoder depth of the
    checkpoint ``args.load``), with its weights; the checkpoint's missing
    and unexpected keys are printed."""
    sd = read_state_dict(args.load)
    layers = (encoder_depth(sd) if method_of(name) == "fba"
              else PUBLISHED_LAYERS)
    model = build_model(name, agg_window=agg_window, layers=layers,
                        device=args.device)
    missing, unexpected = load_weights(model, sd)
    print(f"loaded {args.load}: {len(missing)} missing keys "
          f"{missing[:5]}, {len(unexpected)} unexpected {unexpected[:5]}")
    return model
