"""The plain reference of the benchmark's matting streams.

A plain PyTorch copy of the eval path of TCVOM's ``vmn_fba`` and
``vmn_gca`` (the windowed stream: per-frame encode, per-matte FAM and
decoder head, paste, uint8), written over a state dict under the
reference code's names. It imports nothing of the program under test and
takes nothing the program made: it is given the benchmark's state dict
and host frames and works out the rest again (sigmas, masks, the trimap
encoding).

:class:`Reference` mirrors a stream: ``encode`` one frame (a batch of
streams), ``matte`` from a (previous, current, next) triple of encodes.
"""
from __future__ import annotations

import torch

from mattebench.reference import common, fba, gca
from mattebench.reference.common import EXACT, FP8, Arith, exact_math

MODELS = {"fba": fba, "gca": gca}

__all__ = ["Arith", "EXACT", "FP8", "MODELS", "Reference", "exact_math",
           "spec"]


def spec(config: dict) -> dict[str, tuple[int, ...]]:
    """The state dict's names and shapes for a configuration file's
    contents."""
    return MODELS[config["method"]].spec(config)


class Reference:
    """The stream of ``config`` (a configuration file's contents) over
    ``state_dict``, computed as ``arith`` says (f32 by default)."""

    def __init__(self, config: dict, state_dict: dict, arith: Arith = EXACT):
        self.config = config
        self.model = MODELS[config["method"]]
        self.sd = state_dict
        self.ar = arith
        self.window = config["agg_window"]

    def encode(self, img_u8: torch.Tensor, tri_u8: torch.Tensor) -> dict:
        """One frame of each stream: uint8 ``[N, H, W, 3]`` (BGR) and
        ``[N, H, W, 1]``."""
        pre = common.preprocess(img_u8, tri_u8, self.model.TRIMAP_CHANNELS)
        x = common.nchw(torch.cat([pre["imgs"], pre["tris"]], dim=-1))
        extras = (common.nchw(pre["scaled"]), common.nchw(pre["tris"][..., -2:]))
        enc, feat = self.model.encode(self.ar, self.sd, x, extras)
        q, k, v = common.fam_projections(self.ar, self.sd, feat)
        return dict(enc=enc, q=q, k=k, v=v, trimask=common.nchw(pre["trimask"]),
                    tri=tri_u8)

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

