"""VMN: temporal aggregation (TAM/FAM) over a matting backbone (port of
tcvom_tpu/models/vmn.py), NCHW.

As in the reference, the FAM lives inside the decoder
(``decoder.fam.{key,query,value}_conv``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tcvom_tpu_torch.ops import fam as fam_ops
from tcvom_tpu_torch.ops.image import resize_nearest


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


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


class VMN(nn.Module):
    """Temporal wrapper: per-frame encode + extract, FAM over the window,
    decoder head."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 fam_channels: int, agg_window: int = 7,
                 agg_reduction: int = 1):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.decoder.fam = FeatureAggregationModule(
            fam_channels, agg_reduction, agg_window)

    @property
    def fam(self) -> FeatureAggregationModule:
        return self.decoder.fam

    def encode_extract_qkv(self, images, extras):
        """Per-frame half: encoder, decoder feature-extract (OS=8) and the
        frame's FAM projections. Returns (enc, {"q", "k", "v"})."""
        enc = dict(self.encoder(images), extras=extras)
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
