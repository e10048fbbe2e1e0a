"""Model registry (port of tcvom_tpu/models/registry.py)."""
from __future__ import annotations

import torch
import torch.nn as nn

from tcvom_tpu_torch.models.dim import DeepMatting, DIMDecoder, DIMEncoder
from tcvom_tpu_torch.models.fba import FBA, FBADecoder, FBAEncoder
from tcvom_tpu_torch.models.gca import (GCA, DecBasicBlock, EncBasicBlock,
                                        GCADecoder, GCAEncoder,
                                        GuidedCxtAtten)
from tcvom_tpu_torch.models.index import (IndexMatting, IndexMattingDecoder,
                                          IndexMattingEncoder)
from tcvom_tpu_torch.models.layers import (SNConv2d, WSConv2d, at_least_f32,
                                           l2n)
from tcvom_tpu_torch.models.vmn import VMN
from tcvom_tpu_torch.utils.device import resolve_device

TRIMAP_CHANNEL_DICT = {"gca": 3, "dim": 1, "index": 1, "fba": 8}

# FAM channel width at the OS=8 split per backbone (reference VMN_DIM.py:99,
# VMN_GCA.py:15, VMN_FBA.py:9, VMN_Index.py:10)
FAM_CHANNELS = {"dim": 256, "gca": 128, "fba": 256, "index": 32}

# the single-frame model and the VMN's (encoder, decoder) of the methods
# whose constructors take no depth (FBA's take ``layers``)
_SINGLE = {"dim": DeepMatting, "index": IndexMatting, "gca": GCA}
_VMN_PARTS = {"dim": (DIMEncoder, DIMDecoder),
              "index": (IndexMattingEncoder, IndexMattingDecoder),
              "gca": (GCAEncoder, GCADecoder)}


def method_of(model_name: str) -> str:
    """'vmn_fba' -> 'fba', 'dim' -> 'dim'."""
    return model_name[model_name.rfind("_") + 1:]


def _unit_normal(n: int, generator: torch.Generator) -> torch.Tensor:
    return l2n(torch.randn(n, generator=generator))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers: He-normal for weight-standardized
    convs, Xavier-uniform for plain convs and for spectral-norm convs'
    ``weight_bar`` (and unit normals for their ``u`` and ``v``), zero biases,
    unit norms with BatchNorm's running statistics at mean 0, variance 1.
    GCA's own (tcvom_tpu/models/gca.py:30-68): the trimap input channels of
    the encoder's ``conv1`` zeroed, the residual blocks' ``bn2`` scales at
    0, the attention's ``W`` BatchNorm scale at 1e-3."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SNConv2d):
                p = m.module
                nn.init.xavier_uniform_(p.weight_bar, generator=generator)
                p.weight_u.copy_(_unit_normal(p.weight_u.numel(), generator))
                p.weight_v.copy_(_unit_normal(p.weight_v.numel(), generator))
                continue
            if isinstance(m, WSConv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
                nn.init.ones_(m.weight)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        for m in model.modules():
            if isinstance(m, GCAEncoder):
                m.conv1.module.weight_bar[:, 3:] = 0.0
            elif isinstance(m, (EncBasicBlock, DecBasicBlock)):
                nn.init.zeros_(m.bn2.weight)
            elif isinstance(m, GuidedCxtAtten):
                nn.init.constant_(m.W[1].weight, 1e-3)


def build_model(model_name: str, agg_window: int = 7, agg_reduction: int = 1,
                layers=(3, 4, 6, 3), device: str | torch.device = "cuda",
                generator: torch.Generator | None = None,
                freeze_backbone: bool = False) -> nn.Module:
    """Construct a model with random weights drawn from ``generator``
    (seed 0 if None), in eval mode on ``device`` (``.train()`` switches it,
    as the trainer does; FBA has no layer that depends on the mode, DIM's,
    IndexNet's and GCA's BatchNorms, IndexNet's Dropout and GCA's power
    iteration do). ``'vmn_<method>'`` is the VMN (window ``agg_window``),
    ``'<method>'`` the single-frame model, for the methods fba, dim, index
    and gca. ``layers`` sets FBA's encoder blocks per stage (depth only;
    widths are the published ones; the other backbones ignore it);
    ``freeze_backbone`` runs the encoder and the extract half of a VMN
    without gradient."""
    dev = resolve_device(device)
    method = method_of(model_name)
    if method != "fba" and method not in _SINGLE:
        raise ValueError(f"unknown model {model_name!r}")
    if model_name.startswith("vmn_"):
        parts = ((FBAEncoder(layers=tuple(layers)), FBADecoder())
                 if method == "fba"
                 else tuple(cls() for cls in _VMN_PARTS[method]))
        model = VMN(*parts, FAM_CHANNELS[method], agg_window, agg_reduction,
                    freeze_backbone)
    else:
        model = FBA(layers) if method == "fba" else _SINGLE[method]()
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def calibrate_random_weights(model: nn.Module, forward) -> None:
    """Data-dependent initialisation of random weights, for smoke runs and
    tests: a chain of random layers lets its signal decay or saturate, and
    then every matte is 0 or 1. One call of ``forward()`` (a pass of
    ``model`` over some input), without gradient, in which every BatchNorm
    normalizes with the pass's batch statistics and keeps them as its
    running statistics, and every convolution's weight and bias are
    divided by the RMS of its output (LSUV), so that each layer hands on
    a signal of unit scale. Dropout stays as it is (off in eval mode).
    Spectral-norm convs are left as they are: scaling ``weight_bar``
    scales sigma with it (give them a sigma first,
    :func:`converge_spectral_norms`). Each BatchNorm's mode is restored
    after."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    modes = [bn.training for bn in bns]

    def unit_rms(conv, _, out):
        s = out.float().square().mean().sqrt().clamp_min(1e-12)
        conv.weight.div_(s.to(conv.weight.dtype))
        if conv.bias is not None:
            conv.bias.div_(s.to(conv.bias.dtype))
        return out / s.to(out.dtype)

    hooks = [m.register_forward_hook(unit_rms) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None              # the running statistics = this pass's
        bn.train()
    try:
        with torch.no_grad():
            forward()
    finally:
        for h in hooks:
            h.remove()
        for bn, mode in zip(bns, modes):
            bn.momentum = 0.1
            bn.train(mode)


def converge_spectral_norms(model: nn.Module) -> None:
    """Set ``u`` and ``v`` of every spectral-norm conv to the leading
    singular vectors of its weight, where the power iteration converges:
    sigma is then the weight's spectral norm. For smoke runs and tests of
    random weights: with ``u`` and ``v`` drawn at random (the JAX package's
    initialisation too), ``sigma = u . W v`` is near 0 and of either sign,
    and the network's signal blows up. On the CPU the SVDs run on one
    thread: LAPACK's threads stall each other when several processes
    share the cores (a CPU test run with several workers), and 70 SVDs
    then take minutes instead of seconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, SNConv2d):
                    p = m.module
                    w = at_least_f32(p.weight_bar)
                    u, _, vh = torch.linalg.svd(w.reshape(w.shape[0], -1),
                                                full_matrices=False)
                    p.weight_u.copy_(u[:, 0])
                    p.weight_v.copy_(vh[0])
    finally:
        torch.set_num_threads(threads)
