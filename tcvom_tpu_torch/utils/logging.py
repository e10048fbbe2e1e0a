"""Loss reports (port of tcvom_tpu/utils/logging.py::print_loss_dict)."""
from __future__ import annotations


def print_loss_dict(loss: dict, save: str | None = None):
    """Print ``name: value`` lines in key order, and write them to ``save``
    (the reference's loss.log)."""
    s = "".join("{}: {:.6f}\n".format(k, loss[k]) for k in sorted(loss))
    print(s)
    if save is not None:
        with open(save, "w") as f:
            f.write(s)
