"""Experiment logging (port of tcvom_tpu/utils/logging.py, reference
utils/utils.py:125-183): a file and console logger in
``<outdir>/<cfg_name>/``, a running-average meter and loss reports."""
from __future__ import annotations

import logging
import time
from pathlib import Path


class AverageMeter:
    """The last value and the weighted running average."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, weight: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * weight
        self.count += weight

    def value(self) -> float:
        return self.val

    def average(self) -> float:
        return self.sum / max(self.count, 1)


def create_logger(output_dir: str, cfg_name: str, phase: str = "train"):
    """The root logger at INFO, to ``<output_dir>/<cfg_name>/<cfg_name>_
    <time>_<phase>.log`` and the console. Returns (logger, that folder)."""
    final = Path(output_dir) / cfg_name
    final.mkdir(parents=True, exist_ok=True)
    log_file = final / "{}_{}_{}.log".format(
        cfg_name, time.strftime("%Y-%m-%d-%H-%M"), phase)
    logging.basicConfig(filename=str(log_file),
                        format="%(asctime)-15s %(message)s", force=True)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    logger.addHandler(logging.StreamHandler())
    return logger, str(final)


def print_loss_dict(loss: dict, save: str | None = None):
    """Print ``name: value`` lines in key order, and write them to ``save``
    (the reference's loss.log)."""
    s = "".join("{}: {:.6f}\n".format(k, loss[k]) for k in sorted(loss))
    print(s)
    if save is not None:
        with open(save, "w") as f:
            f.write(s)
