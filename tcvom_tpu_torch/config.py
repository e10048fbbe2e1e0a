"""Configuration: defaults + YAML overlay + CLI ``opts`` overrides (the
port's copy of tcvom_tpu/config.py).

The reference's yacs schema (config.py:1-54) under the same keys, so that
every ``cfgs/*.yaml`` reads unchanged, with the JAX package's merge rules:
a string where the default is not a string is read as a Python literal
(PyYAML reads ``1e-4`` and ``(512, 512)`` as strings), lists become
tuples where the default is a tuple, and an unknown key raises.
"""
from __future__ import annotations

import ast
import copy
from typing import Any

import yaml

_DEFAULTS: dict[str, Any] = {
    "MODEL": "vmn_fba",
    "AGG_WINDOW": 7,
    "SYSTEM": {
        "NUM_WORKERS": 4,
        "RANDOM_SEED": -1,
        "OUTDIR": "train_log",
        "EXP_SUFFIX": "",
        # cudnn flags kept for config-file compatibility; not read
        "CUDNN_BENCHMARK": True,
        "CUDNN_DETERMINISTIC": False,
        "CUDNN_ENABLED": True,
    },
    "DATASET": {
        "PATH": "",
        "SUBSET": False,
    },
    "TRAIN": {
        "LOAD_CKPT": "",
        "LOAD_OPT": "",
        "LOAD_IMAGENET": "",           # torch ResNet state_dict for encoder
                                       # init (train_single_ddp.py:186-196)
        "FREEZE_BACKBONE": False,
        "BATCH_SIZE_PER_GPU": 1,
        "VAL_BATCH_SIZE_PER_GPU": 1,
        "BASE_LR": 5e-4,
        "LR_STRATEGY": "const",        # 'poly' or 'const'
        "WEIGHT_DECAY": 1e-4,
        "TRAIN_INPUT_SIZE": (512, 512),
        "VAL_INPUT_SIZE": (512, 512),
        "MIN_EDGE_LENGTH": 1088,
        "OPTIMIZER": "adam",
        "TOTAL_STEPS": 50,             # epochs, as in the reference
        "PRINT_FREQ": 10,
        "IMAGE_FREQ": 500,
        # the JAX package's experimental bf16-compute training; the port
        # trains in f32 and refuses it (tools/train.py)
        "BF16": False,
    },
}


class Config:
    """Nested attribute-style config (read-only after freeze())."""

    def __init__(self, d: dict):
        self._frozen = False
        for k, v in d.items():
            object.__setattr__(self, k, Config(v) if isinstance(v, dict) else v)

    def __setattr__(self, k, v):
        if getattr(self, "_frozen", False):
            raise AttributeError(f"Config is frozen; cannot set {k}")
        object.__setattr__(self, k, v)

    def freeze(self) -> "Config":
        object.__setattr__(self, "_frozen", True)
        for v in self.__dict__.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.__dict__.items() if k != "_frozen"}

    def __repr__(self):
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=True)


def _coerce(default, v):
    """``v`` for a key whose default is ``default``: a string read as a
    Python literal where the default is not a string (yacs compatibility:
    the reference's files write tuples as "(512, 512)", and PyYAML reads
    ``1e-4`` as a string), a list as a tuple where the default is one."""
    if isinstance(v, str) and not isinstance(default, str):
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    if isinstance(default, tuple) and isinstance(v, list):
        v = tuple(v)
    return v


def _merge(base: dict, overlay: dict, path: str = "") -> dict:
    for k, v in overlay.items():
        if k not in base:
            raise KeyError(f"Unknown config key: {path}{k}")
        if isinstance(base[k], dict):
            _merge(base[k], v, path + k + ".")
        else:
            base[k] = _coerce(base[k], v)
    return base


def _parse_value(s: Any):
    if not isinstance(s, str):
        return s
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def get_cfg_defaults() -> dict:
    return copy.deepcopy(_DEFAULTS)


def load_config(yaml_path: str | None = None, opts: list | None = None,
                frozen: bool = True) -> Config:
    """Defaults <- YAML file <- ['KEY.SUBKEY', value, ...] CLI pairs
    (the reference's merge_from_file / merge_from_list flow,
    train_ddp.py:367-370). A CLI value is read as YAML, then coerced as a
    file's value is: ``TRAIN.BASE_LR 1e-3`` is the float 0.001 (the JAX
    package's ``load_config`` leaves it the string '1e-3')."""
    d = get_cfg_defaults()
    if yaml_path:
        with open(yaml_path) as f:
            _merge(d, yaml.safe_load(f) or {})
    if opts:
        if len(opts) % 2:
            raise ValueError(f"opts must be KEY VALUE pairs, got {opts}")
        for k, v in zip(opts[::2], opts[1::2]):
            *parents, leaf = k.split(".")
            node = d
            for p in parents:
                node = node[p]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {k}")
            node[leaf] = _coerce(node[leaf], _parse_value(v))
    cfg = Config(d)
    return cfg.freeze() if frozen else cfg
