"""Model registry (port of tcvom_tpu/models/registry.py)."""
from __future__ import annotations

import torch
import torch.nn as nn

from tcvom_tpu_torch.models.fba import FBA, FBADecoder, FBAEncoder
from tcvom_tpu_torch.models.layers import WSConv2d
from tcvom_tpu_torch.models.vmn import VMN
from tcvom_tpu_torch.utils.device import resolve_device

TRIMAP_CHANNEL_DICT = {"gca": 3, "dim": 1, "index": 1, "fba": 8}

# FAM channel width at the OS=8 split per backbone (reference VMN_DIM.py:99,
# VMN_GCA.py:15, VMN_FBA.py:9, VMN_Index.py:10)
FAM_CHANNELS = {"dim": 256, "gca": 128, "fba": 256, "index": 32}


def method_of(model_name: str) -> str:
    """'vmn_fba' -> 'fba', 'dim' -> 'dim'."""
    return model_name[model_name.rfind("_") + 1:]


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers: He-normal for weight-standardized
    convs, Xavier-uniform for plain convs, zero biases, unit norms."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WSConv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def build_model(model_name: str, agg_window: int = 7, agg_reduction: int = 1,
                layers=(3, 4, 6, 3), device: str | torch.device = "cuda",
                generator: torch.Generator | None = None,
                freeze_backbone: bool = False) -> nn.Module:
    """Construct a model with random weights drawn from ``generator``
    (seed 0 if None), in eval mode on ``device`` (``.train()`` switches it,
    as the trainer does; FBA has no layer that depends on the mode).
    ``'vmn_fba'`` is the VMN (window ``agg_window``), ``'fba'`` the
    single-frame model. ``layers`` sets the encoder's blocks per stage
    (depth only; widths are the published ones); ``freeze_backbone`` runs
    the encoder and the extract half of a VMN without gradient."""
    dev = resolve_device(device)
    if model_name == "vmn_fba":
        model = VMN(FBAEncoder(layers=tuple(layers)), FBADecoder(),
                    FAM_CHANNELS["fba"], agg_window, agg_reduction,
                    freeze_backbone)
    elif model_name == "fba":
        model = FBA(layers)
    else:
        raise NotImplementedError(
            f"{model_name!r} is not ported yet: ROADMAP.md Queue 1 item 10 "
            "(the other backbones)")
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()
