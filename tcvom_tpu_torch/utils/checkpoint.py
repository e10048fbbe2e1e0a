"""Model weights in the reference's ``.pth`` format (port of the ``.pth``
branch of tcvom_tpu/utils/checkpoint.py::load_weights).

The port's modules carry the reference ``state_dict`` key names, so a
published checkpoint loads as it is, and the JAX package's own
``load_weights`` reads what :func:`save_weights` writes. Orbax checkpoints
of the JAX package are not read here: ``.pth`` is the format both packages
share.
"""
from __future__ import annotations

import os

import torch


def save_weights(model: torch.nn.Module, path: str) -> None:
    """``torch.save`` of the model's ``state_dict``, on the CPU."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def read_state_dict(path: str) -> dict:
    """A ``.pth`` state_dict on the CPU: a ``"state_dict"`` entry is
    unwrapped and a ``module.`` prefix (DataParallel) stripped."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); the port reads .pth state_dicts only: ROADMAP.md "
            "Queue 1 item 8")
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def load_weights(model: torch.nn.Module, checkpoint: str | dict, logger=None
                 ) -> tuple[list[str], list[str]]:
    """Load a ``.pth`` file (see :func:`read_state_dict`) or a state_dict
    into ``model`` partially (the reference's ``strict=False`` loads,
    train_ddp.py:263-267). Returns (missing, unexpected) key lists, sorted;
    a key whose shape differs from the model's counts as unexpected and is
    not loaded, as the JAX package's ``merge_variables`` treats it."""
    sd = (read_state_dict(checkpoint) if isinstance(checkpoint, str)
          else checkpoint)
    own = model.state_dict()
    skip = {k for k, v in sd.items()
            if k not in own or tuple(v.shape) != tuple(own[k].shape)}
    result = model.load_state_dict(
        {k: v for k, v in sd.items() if k not in skip}, strict=False)
    missing = sorted(set(result.missing_keys) - skip)
    unexpected = sorted(skip)
    if logger:
        logger.info("Missing keys: %s", missing)
        logger.info("Unexpected keys: %s", unexpected)
    return missing, unexpected
