"""Task configuration and eval preprocessing (port of the inference half of
tcvom_tpu/models/full_model.py). Tensors here are ``[B, H, W, C]`` f32 in
[0, 255], BGR, as the JAX package takes them."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tcvom_tpu_torch.models import registry
from tcvom_tpu_torch.ops.distance import trimap_transform

IMG_SCALE = 1.0 / 255.0
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    model: str                         # e.g. 'vmn_fba'
    agg_window: int = 7
    agg_reduction: int = 1
    dilate_radius: int | None = None   # fixed trimap dilation (not ported)

    @property
    def method(self) -> str:
        return registry.method_of(self.model)

    @property
    def trimap_channels(self) -> int:
        return registry.TRIMAP_CHANNEL_DICT[self.method]

    @property
    def is_vmn(self) -> bool:
        return self.model.startswith("vmn")


def preprocess_eval(img: torch.Tensor, tri: torch.Tensor,
                    cfg: TaskConfig) -> dict:
    """EvalModel preprocessing from real trimaps (reference
    models/model.py:360-387). ``img`` BGR, ``tri`` a hard trimap whose
    fg/bg pixels are exactly 255/0; both f32 in [0, 255].

    The scale is a multiply by the f32 constant 1/255 (not a divide), so
    that tri = 255 maps to exactly 1.0, as in the JAX package; the 8-channel
    FBA encoding then takes fg/bg by exact equality."""
    if cfg.dilate_radius is not None:
        raise NotImplementedError(
            "static-radius dilate_by_radius is not ported yet: ROADMAP.md "
            "Queue 1 item 2")
    scaled_imgs = img.flip(-1) * IMG_SCALE
    mean = torch.tensor(IMG_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMG_STD, dtype=torch.float32, device=img.device)
    imgs = (scaled_imgs - mean) / std
    scaled_tris = tri * IMG_SCALE
    trimask = ((scaled_tris > 0) & (scaled_tris < 1)).float()
    tc = cfg.trimap_channels
    if tc == 1:
        tris = scaled_tris
    elif tc == 3:
        tri1 = torch.where(trimask > 0.5, 1.0, 2.0 * scaled_tris).long()
        tris = F.one_hot(tri1[..., 0], 3).float()
    else:
        t2f = (scaled_tris == 1.0).float()
        t2b = (scaled_tris == 0.0).float()
        tri2 = torch.cat([t2b, t2f], dim=-1)
        tris = torch.cat([trimap_transform(tri2), tri2], dim=-1)
    return dict(scaled_imgs=scaled_imgs, tris=tris, trimasks=trimask,
                imgs=imgs)
