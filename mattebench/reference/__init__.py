"""The plain reference of the benchmark's matting streams.

A plain PyTorch copy of the eval path of TCVOM's windowed stream
(per-frame encode, per-matte FAM and decoder head, paste, uint8), written
over a state dict under the reference code's names. It imports nothing of
the program under test and takes nothing the program made: it is given
the benchmark's state dict and host frames and works out the rest again
(sigmas, masks, the trimap encoding).

Each method is a module of this folder, found by the configuration's
``method`` (``mattebench/reference/<method>.py``), with:

- ``spec(config)``: every parameter's and buffer's shape, by name;
- ``prepare(img_u8, tri_u8)``: from uint8 frames ``[N, H, W, 3]`` (BGR)
  and trimaps ``[N, H, W, 1]``, the network's input ``x``, the ``extras``
  its halves also read and the unknown mask ``trimask`` the FAM reads,
  NCHW;
- ``encode(ar, sd, x, extras)``: (what the head reads, the features the
  FAM's projections take);
- ``head(ar, sd, enc, v)``: alpha ``[N, 1, H, W]`` from the FAM output.

:class:`Reference` mirrors a stream: ``encode`` one frame (a batch of
streams), ``matte`` from a (previous, current, next) triple of encodes.
"""
from __future__ import annotations

import torch

from mattebench.lookup import package_module
from mattebench.reference import common
from mattebench.reference.common import EXACT, FP8, Arith, exact_math

__all__ = ["Arith", "EXACT", "FP8", "Reference", "exact_math", "method",
           "spec"]


def method(config: dict):
    """The module of a configuration's ``method``."""
    return package_module("reference", config["method"])


def spec(config: dict) -> dict[str, tuple[int, ...]]:
    """The state dict's names and shapes for a configuration file's
    contents."""
    return method(config).spec(config)


class Reference:
    """The stream of ``config`` (a configuration file's contents) over
    ``state_dict``, computed as ``arith`` says (f32 by default)."""

    def __init__(self, config: dict, state_dict: dict, arith: Arith = EXACT):
        self.config = config
        self.model = method(config)
        self.sd = state_dict
        self.ar = arith
        self.window = config["agg_window"]

    def encode(self, img_u8: torch.Tensor, tri_u8: torch.Tensor) -> dict:
        """One frame of each stream: uint8 ``[N, H, W, 3]`` (BGR) and
        ``[N, H, W, 1]``."""
        pre = self.model.prepare(img_u8, tri_u8)
        enc, feat = self.model.encode(self.ar, self.sd, pre["x"], pre["extras"])
        q, k, v = common.fam_projections(self.ar, self.sd, feat)
        return dict(enc=enc, q=q, k=k, v=v, trimask=pre["trimask"], tri=tri_u8)

    def aggregate(self, prev: dict, cur: dict, nxt: dict) -> torch.Tensor:
        """The FAM output of ``cur`` against its neighbours' keys."""
        return common.fam_aggregate(self.ar, self.sd, self.window, cur["q"],
                                    cur["v"], prev["k"], nxt["k"],
                                    cur["trimask"])

    def alpha(self, prev: dict, cur: dict, nxt: dict) -> torch.Tensor:
        return self.model.head(self.ar, self.sd, cur["enc"],
                               self.aggregate(prev, cur, nxt))

    def calibrate(self, img_u8: torch.Tensor, tri_u8: torch.Tensor) -> None:
        """Set every BatchNorm's running statistics in the state dict to
        those of one pass over this frame (its own neighbour on both
        sides), layer after layer."""
        with common.calibrating(), exact_math(), torch.no_grad():
            enc = self.encode(img_u8, tri_u8)
            self.alpha(enc, enc, enc)

    def matte(self, prev: dict, cur: dict, nxt: dict) -> torch.Tensor:
        """uint8 ``[N, H, W]``: the matte of ``cur``."""
        return common.paste_quantize(self.alpha(prev, cur, nxt), cur["tri"])
