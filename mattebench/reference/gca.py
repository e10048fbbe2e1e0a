"""GCA Matting with the temporal aggregation module (TCVOM's ``vmn_gca``),
eval path, in plain PyTorch over a state dict.

GCA (Li and Lu, arXiv:2001.04069): a ResNet-D encoder of basic blocks
(3, 4, 4, 2) with spectral-normalized convolutions and BatchNorm on a
6-channel input (normalized RGB, the one-hot trimap), five shortcut heads,
a guidance head on the RGB image and guided contextual attention at OS 8
in the encoder and in a decoder of blocks (2, 3, 3, 2). TCVOM
(arXiv:2105.11427) splits the decoder after its attention (OS 8, 128
channels) and puts its FAM there.

Spectral normalization in eval mode: the conv runs with ``weight_bar /
sigma``, ``sigma = u . (W v)``, ``W`` the weight flattened to its first
axis (a transposed conv's IOHW weight: its input channels), ``u`` and
``v`` as the state dict holds them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mattebench.reference.common import (Arith, batch_norm, conv,
                                         conv_transpose, matmul, nchw,
                                         preprocess, resize_nearest)

TRIMAP_CHANNELS = 3
SHORTCUTS = ((6, 32), (32, 32), (64, 64), (128, 128), (256, 256))
GUIDANCE = (16, 32, 128)


def spec(config: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter and buffer's shape, by name (``num_batches_tracked``
    is ``()``)."""
    out: dict[str, tuple[int, ...]] = {}

    def sn(name, cout, cin, k, transpose=False):
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        out[name + ".module.weight_bar"] = shape
        out[name + ".module.weight_u"] = (shape[0],)
        out[name + ".module.weight_v"] = (shape[1] * k * k,)

    def bn(name, ch):
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{s}"] = (ch,)
        out[name + ".num_batches_tracked"] = ()

    def attention(p):
        out[p + "guidance_conv.weight"] = (64, 128, 1, 1)
        out[p + "guidance_conv.bias"] = (64,)
        out[p + "W.0.weight"] = (128, 128, 1, 1)
        bn(p + "W.1", 128)

    sn("encoder.conv1", 32, 3 + TRIMAP_CHANNELS, 3)
    bn("encoder.bn1", 32)
    sn("encoder.conv2", 32, 32, 3)
    bn("encoder.bn2", 32)
    sn("encoder.conv3", 64, 32, 3)
    bn("encoder.bn3", 64)
    cin = 3
    for i, feat in enumerate(GUIDANCE):
        sn(f"encoder.guidance_head.{4 * i + 1}", feat, cin, 3)
        bn(f"encoder.guidance_head.{4 * i + 3}", feat)
        cin = feat
    cin = 64
    for name, planes, blocks, stride in zip(
            ("layer1", "layer2", "layer3", "layer_bottleneck"),
            (64, 128, 256, 512), config["encoder_layers"], (1, 2, 2, 2)):
        for j in range(blocks):
            p = f"encoder.{name}.{j}."
            sn(p + "conv1", planes, cin, 3)
            bn(p + "bn1", planes)
            sn(p + "conv2", planes, planes, 3)
            bn(p + "bn2", planes)
            if j == 0 and stride != 1:
                sn(p + "downsample.1", planes, cin, 1)
                bn(p + "downsample.2", planes)
            cin = planes
    for i, (c_in, planes) in enumerate(SHORTCUTS):
        sn(f"encoder.shortcut.{i}.0", planes, c_in, 3)
        bn(f"encoder.shortcut.{i}.2", planes)
        sn(f"encoder.shortcut.{i}.3", planes, planes, 3)
        bn(f"encoder.shortcut.{i}.5", planes)
    attention("encoder.gca.")
    cin = 512
    for i, (planes, blocks) in enumerate(zip((256, 128, 64, 32),
                                             config["decoder_layers"]), 1):
        for j in range(blocks):
            p = f"decoder.layer{i}.{j}."
            sn(p + "conv1", cin, cin, 4 if j == 0 else 3, transpose=j == 0)
            bn(p + "bn1", cin)
            sn(p + "conv2", planes, cin, 3)
            bn(p + "bn2", planes)
            if j == 0:
                sn(p + "upsample.1", planes, cin, 1)
                bn(p + "upsample.2", planes)
            cin = planes
    sn("decoder.conv1", 32, 32, 4, transpose=True)
    bn("decoder.bn1", 32)
    out["decoder.conv2.weight"] = (1, 32, 3, 3)
    out["decoder.conv2.bias"] = (1,)
    attention("decoder.gca.")
    c = config["fam_channels"]
    for n in ("key", "query", "value"):
        out[f"decoder.fam.{n}_conv.weight"] = (c, c, 3, 3)
        out[f"decoder.fam.{n}_conv.bias"] = (c,)
    return out


def prepare(img_u8: torch.Tensor, tri_u8: torch.Tensor) -> dict:
    """The 6-channel input ``x`` (normalized RGB, the one-hot trimap) and
    the unknown mask ``trimask``, NCHW f32, of uint8 frames and trimaps;
    no ``extras``."""
    pre = preprocess(img_u8, tri_u8, TRIMAP_CHANNELS)
    return dict(x=nchw(torch.cat([pre["imgs"], pre["tris"]], dim=-1)),
                extras=None, trimask=nchw(pre["trimask"]))


def _sn_weight(ar: Arith, sd: dict, name: str) -> torch.Tensor:
    w = sd[name + ".module.weight_bar"].to(ar.wide)
    u = sd[name + ".module.weight_u"].to(ar.wide)
    v = sd[name + ".module.weight_v"].to(ar.wide)
    sigma = u @ (w.reshape(w.shape[0], -1) @ v)
    return w / sigma


def _sn(ar, sd, name, x, stride=1, padding=0):
    return conv(ar, x, _sn_weight(ar, sd, name), None, stride, padding)


def _sn_t(ar, sd, name, x):
    """The (4, 2, 1) transposed spectral-norm conv."""
    return conv_transpose(ar, x, _sn_weight(ar, sd, name), 2, 1)


def _bn(ar, sd, name, x):
    return batch_norm(ar, x, sd, name)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


def _enc_block(ar, sd, p, x, stride):
    out = F.relu(_bn(ar, sd, p + "bn1", _sn(ar, sd, p + "conv1", x, stride, 1)))
    out = _bn(ar, sd, p + "bn2", _sn(ar, sd, p + "conv2", out, 1, 1))
    if p + "downsample.1.module.weight_bar" in sd:
        x = _bn(ar, sd, p + "downsample.2",
                _sn(ar, sd, p + "downsample.1", F.avg_pool2d(x, 2, 2)))
    return F.relu(out + x)


def _dec_block(ar, sd, p, x):
    if p + "upsample.1.module.weight_bar" in sd:
        out = _sn_t(ar, sd, p + "conv1", x)
        up = resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1]))
        x = _bn(ar, sd, p + "upsample.2", _sn(ar, sd, p + "upsample.1", up))
    else:
        out = _sn(ar, sd, p + "conv1", x, 1, 1)
    out = _leaky(_bn(ar, sd, p + "bn1", out))
    out = _bn(ar, sd, p + "bn2", _sn(ar, sd, p + "conv2", out, 1, 1))
    return _leaky(out + x)


def _layer(ar, sd, prefix, x, block, *args):
    j = 0
    while f"{prefix}.{j}.conv1.module.weight_bar" in sd:
        x = block(ar, sd, f"{prefix}.{j}.", x, *(args if j == 0 else (1,) * len(args)))
        j += 1
    return x


def _patches(x, kernel: int, stride: int):
    """Reflect-padded ``kernel`` x ``kernel`` patches at ``stride``
    (left pad (k-s+1)//2, right (k-s)//2): ``[B, C*k*k, N]``."""
    left, right = (kernel - stride + 1) // 2, (kernel - stride) // 2
    xp = F.pad(x, (left, right, left, right), mode="reflect")
    return F.unfold(xp, kernel, stride=stride)


def attention_core(ar: Arith, f, alpha, unknown):
    """Guided contextual attention: every query patch of the guidance
    ``f`` (``[B, C, h, w]``) against every 3x3 patch, normalized, scaled by
    the unknown and known regions' scales, its own patch masked out where
    unknown, softmax; alpha's 4x4 stride-2 patches reconstructed with
    those weights and overlap-added (/4). Returns ``[B, Ca, 2h, 2w]``."""
    b, _, h, w = f.shape
    x = _patches(f, 3, 1)
    xw = x.to(ar.wide)
    bank = xw / torch.linalg.vector_norm(xw, dim=1, keepdim=True).clamp_min(1e-4)
    corr = matmul(ar, x.transpose(1, 2), bank.to(x.dtype))
    unk = unknown.to(ar.wide)
    um = unk.mean(dim=(1, 2, 3))
    km = 1.0 - um
    s_un = torch.sqrt(um / km.clamp_min(1e-12)).clamp(0.1, 10.0)
    s_kn = torch.sqrt(km / um.clamp_min(1e-12)).clamp(0.1, 10.0)
    mm = (_patches(unk, 3, 1).mean(dim=1) > 0).to(corr.dtype)
    corr = corr * (s_un[:, None] * mm + s_kn[:, None] * (1.0 - mm))[:, None, :]
    corr.diagonal(dim1=1, dim2=2).sub_(1e4 * mm)
    att = torch.softmax(corr, dim=-1)
    z = matmul(ar, _patches(alpha, 4, 2), att.to(alpha.dtype).transpose(1, 2))
    return F.fold(z, (2 * h, 2 * w), 4, stride=2, padding=1) / 4.0


def _gca(ar, sd, p, f, alpha, unknown):
    f = conv(ar, f, sd[p + "guidance_conv.weight"], sd[p + "guidance_conv.bias"])
    hw = (f.shape[-2] // 2, f.shape[-1] // 2)
    y = attention_core(ar, resize_nearest(f, hw), alpha,
                       resize_nearest(unknown, hw))
    y = _bn(ar, sd, p + "W.1", conv(ar, y.to(alpha.dtype), sd[p + "W.0.weight"]))
    return y + alpha


def encode(ar: Arith, sd: dict, x: torch.Tensor, extras=None
           ) -> tuple[dict, torch.Tensor]:
    """The per-frame half: the encoder and the decoder's layer1, layer2
    and attention. ``x``: the 6-channel input, NCHW. Returns (the shortcuts
    the head reads, the OS-8 features)."""
    x = x.to(ar.dtype)
    out = F.relu(_bn(ar, sd, "encoder.bn1", _sn(ar, sd, "encoder.conv1", x, 2, 1)))
    x1 = F.relu(_bn(ar, sd, "encoder.bn2", _sn(ar, sd, "encoder.conv2", out, 1, 1)))
    out = F.relu(_bn(ar, sd, "encoder.bn3", _sn(ar, sd, "encoder.conv3", x1, 2, 1)))
    g = x[:, :3]
    for i in range(len(GUIDANCE)):
        g = F.pad(g, (1, 1, 1, 1), mode="reflect")
        g = F.relu(_sn(ar, sd, f"encoder.guidance_head.{4 * i + 1}", g, 2, 0))
        g = _bn(ar, sd, f"encoder.guidance_head.{4 * i + 3}", g)
    unknown = resize_nearest(x[:, 4:5], (x.shape[-2] // 8, x.shape[-1] // 8))
    x2 = _layer(ar, sd, "encoder.layer1", out, _enc_block, 1)
    x3 = _gca(ar, sd, "encoder.gca.", g,
              _layer(ar, sd, "encoder.layer2", x2, _enc_block, 2), unknown)
    x4 = _layer(ar, sd, "encoder.layer3", x3, _enc_block, 2)
    bottleneck = _layer(ar, sd, "encoder.layer_bottleneck", x4, _enc_block, 2)
    fea = []
    for i, t in enumerate((x, x1, x2, x3, x4)):
        p = f"encoder.shortcut.{i}."
        t = _bn(ar, sd, p + "2", F.relu(_sn(ar, sd, p + "0", t, 1, 1)))
        fea.append(_bn(ar, sd, p + "5", F.relu(_sn(ar, sd, p + "3", t, 1, 1))))
    h = _layer(ar, sd, "decoder.layer1", bottleneck, _dec_block) + fea[4]
    h = _layer(ar, sd, "decoder.layer2", h, _dec_block) + fea[3]
    feat = _gca(ar, sd, "decoder.gca.", g, h, unknown)
    return {"shortcut": fea[:3]}, feat


def head(ar: Arith, sd: dict, enc: dict, x: torch.Tensor) -> torch.Tensor:
    """The per-matte half from the FAM output ``x``: alpha ``[N, 1, H, W]``
    in at least f32."""
    f1, f2, f3 = enc["shortcut"]
    h = _layer(ar, sd, "decoder.layer3", x.to(ar.dtype), _dec_block) + f3
    h = _layer(ar, sd, "decoder.layer4", h, _dec_block) + f2
    h = _leaky(_bn(ar, sd, "decoder.bn1", _sn_t(ar, sd, "decoder.conv1", h))) + f1
    out = conv(ar, h, sd["decoder.conv2.weight"], sd["decoder.conv2.bias"],
               padding=1)
    return ((torch.tanh(out) + 1.0) / 2.0).to(ar.wide)
