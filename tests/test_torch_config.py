"""The port's config (defaults, YAML overlay, CLI opts) against the JAX
package's ``load_config``, on every ``cfgs/*.yaml``."""
import glob
import os

import pytest

from tcvom_tpu.config import load_config as jax_load_config
from tcvom_tpu_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yaml")))
# CLI overrides of each kind: a number, a path, a tuple, a bool, an int
OPTS = ["TRAIN.BASE_LR", "0.0002", "TRAIN.LOAD_CKPT", "/tmp/w.pth",
        "TRAIN.TRAIN_INPUT_SIZE", "[64, 64]", "TRAIN.FREEZE_BACKBONE",
        "true", "SYSTEM.NUM_WORKERS", "0", "AGG_WINDOW", "3",
        "TRAIN.VAL_INPUT_SIZE", "[32, 64]"]


def test_all_configs_are_found():
    assert len(CFGS) == 12


@pytest.mark.parametrize("opts", [None, OPTS], ids=["file", "opts"])
@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_config_matches_jax(path, opts):
    got = load_config(path, opts).to_dict()
    assert got == jax_load_config(path, opts).to_dict()
    assert isinstance(got["TRAIN"]["BASE_LR"], float)
    assert isinstance(got["TRAIN"]["TRAIN_INPUT_SIZE"], tuple)


def test_cli_values_are_read_as_file_values():
    """PyYAML reads ``1e-3`` and ``(32, 64)`` as strings; a file's value is
    turned into the number or tuple in both packages, a CLI value in the
    port only (the JAX package's ``load_config`` keeps the string, and its
    trainer would then fail on it)."""
    path = os.path.join(ROOT, "cfgs", "vmd_vmn_dim_pretrained_30ep.yaml")
    opts = ["TRAIN.BASE_LR", "1e-3", "TRAIN.VAL_INPUT_SIZE", "(32, 64)"]
    got, want = load_config(path, opts).TRAIN, jax_load_config(path, opts).TRAIN
    assert (got.BASE_LR, got.VAL_INPUT_SIZE) == (1e-3, (32, 64))
    assert (want.BASE_LR, want.VAL_INPUT_SIZE) == ("1e-3", "(32, 64)")


def test_config_refuses_unknown_keys_and_writes(tmp_path):
    path = CFGS[0]
    with pytest.raises(KeyError, match="TRAIN.NOPE"):
        load_config(path, ["TRAIN.NOPE", "1"])
    with pytest.raises(ValueError, match="pairs"):
        load_config(path, ["TRAIN.BASE_LR"])
    bad = tmp_path / "bad.yaml"
    bad.write_text("TRAIN:\n  NOPE: 1\n")
    with pytest.raises(KeyError, match="TRAIN.NOPE"):
        load_config(str(bad))
    cfg = load_config(path)
    with pytest.raises(AttributeError, match="frozen"):
        cfg.TRAIN.BASE_LR = 1.0
    cfg.dump(str(tmp_path / "dumped.yaml"))
    back = load_config(str(tmp_path / "dumped.yaml")).to_dict()
    assert back == cfg.to_dict()
