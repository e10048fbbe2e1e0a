"""VMN: temporal aggregation (TAM/FAM) over a matting backbone (port of
tcvom_tpu/models/vmn.py), NCHW.

As in the reference, the FAM lives inside the decoder
(``decoder.fam.{key,query,value}_conv``).

``freeze_backbone`` reproduces the reference semantics (VMN_model.py:77-81,
100-104): the encoder and the extract half of the decoder run without
gradient and stay in eval mode under ``.train()`` (their BatchNorms keep
and use their running statistics, their spectral-norm convs do no power
iteration: the JAX package's ``train=False`` there), and the trainer keeps
their parameters out of the optimizer.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tcvom_tpu_torch.models.layers import EncoderDecoder
from tcvom_tpu_torch.ops import fam as fam_ops
from tcvom_tpu_torch.ops.image import resize_nearest


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _tree_map(fn, tree):
    """``fn`` on each tensor of nested dicts and tuples; None stays None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _with_extras(enc: dict, extras) -> dict:
    """The encoder's output with the decoder head's ``extras`` (FBA's raw
    image and 2-channel trimap); the other backbones have none."""
    return enc if extras is None else dict(enc, extras=extras)


class FeatureAggregationModule(nn.Module):
    """q/k/v 3x3 convs + two masked window attentions (reference
    VMN_model.py:9-68). The projections are exposed separately so a stream
    computes them once per frame and caches them."""

    def __init__(self, input_chn: int, reduction: int = 1, window: int = 7):
        super().__init__()
        out_chn = input_chn // reduction
        self.key_conv = nn.Conv2d(input_chn, out_chn, 3, padding=1)
        self.query_conv = nn.Conv2d(input_chn, out_chn, 3, padding=1)
        self.value_conv = nn.Conv2d(input_chn, out_chn, 3, padding=1)
        self.window = window

    def qkv(self, x):
        return self.query_conv(x), self.key_conv(x), self.value_conv(x)

    def aggregate(self, q, v, kb, kf, mask, need_logits: bool = False):
        """Both neighbour attentions from cached projections, as one batched
        ``[prev; next]`` call. ``mask``: ``[N, 1, H', W']`` unknown region at
        any resolution. Returns (features, attb, attf, small_mask); the
        logits are None unless ``need_logits``."""
        n = q.shape[0]
        small = (resize_nearest(mask, q.shape[-2:]) > 0.5).to(q.dtype)
        x2, att2 = fam_ops.fam_attention(
            torch.cat([_nhwc(q), _nhwc(q)]).contiguous(),
            torch.cat([_nhwc(kb), _nhwc(kf)]).contiguous(),
            torch.cat([_nhwc(small), _nhwc(small)]).contiguous(),
            self.window, need_logits=need_logits)
        x2 = x2.permute(0, 3, 1, 2)
        attb, attf = (None, None) if att2 is None else (att2[:n], att2[n:])
        return v + x2[:n] + x2[n:], attb, attf, small

    def forward(self, x, b, f, mask):
        """Center ``x``, previous ``b`` and next ``f`` features, NCHW: the
        projections and :meth:`aggregate`, with the logits."""
        return self.aggregate(self.query_conv(x), self.value_conv(x),
                              self.key_conv(b), self.key_conv(f), mask,
                              need_logits=True)


class VMN(EncoderDecoder):
    """Temporal wrapper: per-frame encode + extract, FAM over the window,
    decoder head."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 fam_channels: int, agg_window: int = 7,
                 agg_reduction: int = 1, freeze_backbone: bool = False):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.decoder.fam = FeatureAggregationModule(
            fam_channels, agg_reduction, agg_window)
        self.freeze_backbone = freeze_backbone

    @property
    def fam(self) -> FeatureAggregationModule:
        return self.decoder.fam

    def train(self, mode: bool = True) -> "VMN":
        super().train(mode)
        if self.freeze_backbone:
            for m in self.frozen_modules():
                m.eval()
        return self

    def encode_extract_qkv(self, images, extras=None):
        """Per-frame half: encoder, decoder feature-extract (OS=8) and the
        frame's FAM projections. Returns (enc, {"q", "k", "v"})."""
        enc = _with_extras(self.encoder(images), extras)
        q, k, v = self.fam.qkv(self.decoder(enc, mode="extract"))
        return enc, {"q": q, "k": k, "v": v}

    def decode_window_qkv(self, enc_c, qkv_c, k_b, k_f, mask,
                          need_logits: bool = False):
        """Center-frame half from cached projections: FAM + decoder head.
        Returns (pred, attb, attf, small_mask)."""
        agg, attb, attf, small = self.fam.aggregate(
            qkv_c["q"], qkv_c["v"], k_b, k_f, mask, need_logits=need_logits)
        pred = self.decoder(enc_c, mode="head", x=agg)
        return pred, attb, attf, small

    def forward(self, images, masks, extras=None):
        """Full clip. ``images``: ``[B, S, Cin, H, W]``; ``masks``: unknown
        region ``[B, S, 1, H, W]``; ``extras``: FBA's tuple of
        ``[B, S, ., H, W]`` (raw image and 2-channel trimap) for the
        decoder head, None for the other backbones.

        Frames fold into the batch: the per-frame half runs once on B*S
        frames and the decode half once on the B*(S-2) centers, each with
        its previous and next frame. Returns (preds ``[B, S, Cout, H, W]``
        with the endpoint frames zero, attb and attf logits
        ``[B, S-2, h, w, window^2]``, small_mask ``[B, S-2, 1, h, w]``)."""
        b, s = images.shape[:2]

        def fold(t):
            return t.reshape((-1,) + t.shape[2:])

        def unfold(t, frames):
            return t.reshape((b, frames) + t.shape[1:])

        def centers(t):
            return fold(unfold(t, s)[:, 1:s - 1])

        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_backbone):
            enc = _with_extras(self.encoder(fold(images)),
                               _tree_map(fold, extras))
            feat = self.decoder(enc, mode="extract")
        feat = unfold(feat, s)
        agg, attb, attf, small = self.fam(
            fold(feat[:, 1:s - 1]), fold(feat[:, 0:s - 2]),
            fold(feat[:, 2:s]), fold(masks[:, 1:s - 1]))
        enc_mid = _tree_map(centers, type(self.decoder).prune_enc_head(enc))
        pred = unfold(self.decoder(enc_mid, mode="head", x=agg), s - 2)
        zero = torch.zeros_like(pred[:, :1])
        return (torch.cat([zero, pred, zero], dim=1), unfold(attb, s - 2),
                unfold(attf, s - 2), unfold(small, s - 2))
