"""The benchmark's weights: a state dict under the reference names, drawn
on the device from the run's seed in one call, handed to the program and
to the reference alike.

Every 4-D weight is Xavier-normal, ``N(0, 2 / (fan_in + fan_out))``
(a weight-standardized or spectral-normalized conv ignores the scale);
norms have unit scale and zero shift, BatchNorm's running statistics mean
0 and variance 1, biases 0. A configuration file may override entries
(``init``: a name pattern, then a ``value`` to fill or a ``scale`` to
multiply, optionally on output channels ``[a, b)`` only and from an input
channel on).
Spectral-norm ``u`` and ``v`` come from a power iteration on the device
(``POWER_ITERATIONS`` steps, each weight of one shape batched with the
others): ``sigma = u . W v`` is then near the weight's largest singular
value, where the random ``u``, ``v`` of an untrained model give a sigma
near 0 and a network whose signal blows up.

A configuration with ``"calibrate_batch_norm": true`` then has every
BatchNorm's running statistics set by the reference from one pass over
the first stream's first frame of the run's traffic, as training leaves
them: each layer's output has unit scale, so that every layer, however
deep, moves the matte. (With running statistics of 0 and 1, each
spectral-norm conv shrinks its input several times over and the deep
layers add nothing a comparison of mattes could see.)
"""
from __future__ import annotations

import math
import re
from collections import defaultdict

import torch

from mattebench import reference

POWER_ITERATIONS = 64


def _l2n(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)


def make_state_dict(config: dict, seed: int, device, frame=None
                    ) -> dict[str, torch.Tensor]:
    """The state dict of ``config`` (a configuration file's contents) for
    ``seed``, f32 on ``device``. ``frame``: the traffic's first host frames
    and trimaps (``[streams, H, W, 3]``, ``[streams, H, W, 1]`` uint8),
    which a configuration that calibrates its BatchNorms needs."""
    shapes = reference.spec(config)
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = [k for k, s in shapes.items() if len(s) == 4]
    draw = torch.randn(sum(math.prod(shapes[k]) for k in convs),
                       generator=gen, device=device)
    sd: dict[str, torch.Tensor] = {}
    at = 0
    for k in convs:
        s = shapes[k]
        n = math.prod(s)
        fans = (s[0] + s[1]) * s[2] * s[3]
        sd[k] = draw[at:at + n].view(s).mul_(math.sqrt(2.0 / fans))
        at += n
    for k, s in shapes.items():
        if k in sd:
            continue
        leaf = k.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            sd[k] = torch.zeros((), dtype=torch.long, device=device)
        elif leaf in ("weight", "running_var"):
            sd[k] = torch.ones(s, device=device)
        else:           # bias, running_mean, weight_u, weight_v (set below)
            sd[k] = torch.zeros(s, device=device)
    for rule in config.get("init", ()):
        hits = [k for k in sd if re.search(rule["key"], k)]
        if not hits:
            raise ValueError(f"init rule {rule} matches no parameter")
        for k in hits:
            rows = slice(*rule.get("out_channels", (None, None)))
            part = sd[k][rows]
            if "from_input_channel" in rule:
                part = part[:, rule["from_input_channel"]:]
            if "scale" in rule:
                part.mul_(rule["scale"])
            else:
                part.fill_(rule["value"])
    _converge_spectral_norms(sd, gen)
    if config.get("calibrate_batch_norm"):
        if frame is None:
            raise ValueError(f"{config['name']} calibrates its BatchNorms "
                             "on the traffic's first frame: pass it")
        img, tri = (t[:1].to(device) for t in frame)
        reference.Reference(config, sd).calibrate(img, tri)
    return sd


def _converge_spectral_norms(sd: dict, gen: torch.Generator) -> None:
    groups = defaultdict(list)
    for k in sd:
        if k.endswith(".module.weight_bar"):
            w = sd[k]
            groups[(w.shape[0], w[0].numel())].append(k[:-len("weight_bar")])
    for (rows, cols), names in sorted(groups.items()):
        w = torch.stack([sd[p + "weight_bar"].reshape(rows, cols)
                         for p in names])
        u = _l2n(torch.randn((len(names), rows), generator=gen,
                             device=w.device))
        for _ in range(POWER_ITERATIONS):
            v = _l2n(torch.bmm(u[:, None, :], w)[:, 0])
            u = _l2n(torch.bmm(w, v[:, :, None])[:, :, 0])
        for i, p in enumerate(names):
            sd[p + "weight_u"].copy_(u[i])
            sd[p + "weight_v"].copy_(v[i])
