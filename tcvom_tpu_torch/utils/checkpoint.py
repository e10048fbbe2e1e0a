"""Model weights in the reference's ``.pth`` format (port of the ``.pth``
branch of tcvom_tpu/utils/checkpoint.py::load_weights), the full train
state in torch's format, and the encoder's ImageNet initialisation.

The port's modules carry the reference ``state_dict`` key names, so a
published checkpoint loads as it is, and the JAX package's own
``load_weights`` reads what :func:`save_weights` writes. Orbax checkpoints
of the JAX package are not read here: ``.pth`` is the format both packages
share. A train state (:func:`save_train_state`) is the counterpart of the
JAX package's orbax ``TrainState`` (tcvom_tpu/utils/checkpoint.py:30-86):
``{"step", "model", "optimizer", "generator"}`` through ``torch.save``.
"""
from __future__ import annotations

import os

import torch


def save_weights(model: torch.nn.Module, path: str) -> None:
    """``torch.save`` of the model's ``state_dict``, on the CPU."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


_TRAIN_STATE_KEYS = {"step", "model", "optimizer", "generator"}


def read_state_dict(path: str) -> dict:
    """A ``.pth`` state_dict on the CPU: a ``"state_dict"`` entry (or a
    train state's ``"model"``) is unwrapped and a ``module.`` prefix
    (DataParallel) stripped."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); the port reads .pth state_dicts only: ROADMAP.md "
            "Queue 1 item 8")
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    elif _TRAIN_STATE_KEYS <= set(sd):
        sd = sd["model"]
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


def save_train_state(path: str, state) -> None:
    """``state`` (a ``train.trainer.TrainState``) to ``path``: the step,
    the model's and the optimizer's state_dicts and the generators'
    states (``{"radius", "dropout"}``, the latter None without dropout)."""
    dropout = state.dropout_generator
    torch.save({
        "step": state.step,
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "generator": {"radius": state.generator.get_state(),
                      "dropout": None if dropout is None
                      else dropout.get_state()}}, path)


def restore_train_state(path: str, state):
    """Resume ``state`` (freshly initialised, the same model and
    optimizer) from a :func:`save_train_state` file, in place: step,
    weights and buffers (strictly), the optimizer's moments and step
    counts, both generators. Returns ``state``. A file of another model or
    optimizer raises (``TRAIN.LOAD_CKPT`` loads weights alone, partially);
    the reference's optimizer resume, train_ddp.py:300-304."""
    ckpt = torch.load(path, map_location="cpu")
    if not isinstance(ckpt, dict) or not _TRAIN_STATE_KEYS <= set(ckpt):
        raise ValueError(f"{path} is not a train state (keys "
                         f"{sorted(_TRAIN_STATE_KEYS)}); TRAIN.LOAD_CKPT "
                         "loads weights alone")
    gens = ckpt["generator"]
    if (gens["dropout"] is None) != (state.dropout_generator is None):
        raise ValueError(f"{path}: the dropout generator does not match "
                         "this model's")
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.generator.set_state(gens["radius"])
    if gens["dropout"] is not None:
        state.dropout_generator.set_state(gens["dropout"])
    state.step = int(ckpt["step"])
    return state


# the stem conv's weight of each backbone, the first of these in the model
_STEMS = ("encoder.conv1.weight", "encoder.conv1.module.weight_bar",
          "encoder.conv11.weight", "encoder.layer0.0.weight")


def load_imagenet_encoder(model: torch.nn.Module, path: str, logger=None
                          ) -> tuple[list[str], list[str]]:
    """Initialise the encoder from a torch ImageNet ResNet state_dict
    (reference train_single_ddp.py:186-196; the JAX package's
    ``load_imagenet_encoder``, tcvom_tpu/utils/checkpoint.py:89-160): its
    keys taken as ``encoder.*``, the stem conv widened to the model's
    input channels with zeros, then a partial load. Returns (missing,
    unexpected), as :func:`load_weights`."""
    sd = {"encoder." + k: v for k, v in read_state_dict(path).items()}
    own = model.state_dict()
    stem = next((k for k in _STEMS if k in own), None)
    if stem is not None and stem in sd:
        have, want = sd[stem].shape[1], own[stem].shape[1]
        if want > have:
            w = sd[stem]
            sd[stem] = torch.cat([w, w.new_zeros(
                (w.shape[0], want - have) + tuple(w.shape[2:]))], dim=1)
            if logger:
                logger.info("ImageNet init: widened %s input %d -> %d "
                            "(zero-init extra channels)", stem, have, want)
    missing, unexpected = load_weights(model, sd)
    if logger:
        logger.info("ImageNet init from %s: missing %d, unexpected %d", path,
                    len(missing), len(unexpected))
        logger.info("Missing keys: %s", missing[:20])
        logger.info("Unexpected keys: %s", unexpected[:20])
    return missing, unexpected
