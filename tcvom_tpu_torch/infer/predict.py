"""Streaming sliding-window inference (port of
tcvom_tpu/infer/predict.py::StreamingPredictor), the production matte path.
"""
from __future__ import annotations

import copy

import torch

from tcvom_tpu_torch.models import full_model as FM
from tcvom_tpu_torch.utils.device import resolve_device


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class StreamingPredictor:
    """Sliding 3-frame VMN inference with cached per-frame features: each
    frame is encoded once (backbone, extract half and FAM projections are
    cached) and each matte costs one FAM-and-decode step.

    Usage::

        sp = StreamingPredictor(model, cfg, dtype=torch.bfloat16,
                                fgbg=False, quantize=True)
        state = None
        for img, tri in frames:          # [B, H, W, {3,1}], 0..255
            state, out = sp.step(state, img, tri)
            if out is not None: ...      # matte for the previous frame
        last = sp.flush(state)
    """

    def __init__(self, model, cfg: FM.TaskConfig, dtype=None,
                 fgbg: bool = True, quantize: bool = False,
                 device: str | torch.device = "cuda"):
        """``dtype=torch.bfloat16`` runs the network in bf16 (the float
        parameters are cast once, on a copy of ``model``); preprocessing,
        the fusion solve and the paste stay f32. ``quantize=True`` (needs
        ``fgbg=False`` for FBA) returns uint8 ``[B, H, W]`` mattes with the
        known trimap pixels pasted back; otherwise alpha ``[B, H, W, 1]``
        f32, and with ``fgbg`` the tuple (alpha, F, B)."""
        if not cfg.is_vmn:
            raise ValueError("the streaming pipeline drives VMN models")
        if quantize and fgbg and cfg.method == "fba":
            raise ValueError("quantize=True returns the alpha matte only "
                             "(set fgbg=False)")
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device).eval()
        if dtype is not None:
            self.model.to(dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.fgbg = fgbg
        self.quantize = quantize

    @torch.inference_mode()
    def encode(self, img, tri) -> dict:
        """One frame's cached state: the decoder head's inputs, the FAM
        projections (q, k, v), the unknown mask and the paste inputs."""
        cfg = self.cfg
        tri_raw = torch.as_tensor(tri, device=self.device)
        img = torch.as_tensor(img, device=self.device).float()
        tri = tri_raw.float()
        pre = FM.preprocess_eval(img, tri, cfg)
        inputs = _nchw(torch.cat([pre["imgs"], pre["tris"]], dim=-1))
        extras = (_nchw(pre["scaled_imgs"]), _nchw(pre["tris"][..., -2:]))
        if self.dtype is not None:
            inputs = inputs.to(self.dtype)
            extras = tuple(t.to(self.dtype) for t in extras)
        enc, qkv = self.model.encode_extract_qkv(inputs, extras)
        out = dict(enc=type(self.model.decoder).prune_enc_head(enc),
                   trimask=_nchw(pre["trimasks"]), **qkv)
        if self.quantize:
            # quantize-then-paste commutes with paste-then-quantize, so the
            # paste runs on uint8 [B, H, W]
            s = tri_raw[..., 0].float() * FM.IMG_SCALE
            out["gt_u8"] = torch.floor(
                torch.clamp(s, 0.0, 1.0) * 255.0).to(torch.uint8)
            out["paste_gate"] = (s > 0.0) & (s < 1.0)
        else:
            out["gt_tri"] = tri * FM.IMG_SCALE
            out["scaled_img"] = pre["scaled_imgs"]
        return out

    @torch.inference_mode()
    def decode(self, prev: dict, cur: dict, nxt: dict):
        """The matte of ``cur`` from its neighbours' keys."""
        pred, _, _, _ = self.model.decode_window_qkv(
            cur["enc"], cur, prev["k"], nxt["k"], cur["trimask"])
        if self.quantize:
            a8 = torch.floor(torch.clamp(pred[:, 0].float(), 0.0, 1.0)
                             * 255.0).to(torch.uint8)
            return torch.where(cur["paste_gate"], a8, cur["gt_u8"])
        pred = pred.permute(0, 2, 3, 1)
        mask = cur["trimask"].permute(0, 2, 3, 1) > 0.5
        alpha = torch.where(mask, pred[..., 0:1], cur["gt_tri"])
        if self.cfg.method == "fba" and self.fgbg:
            f = torch.where(mask, pred[..., 1:4], cur["scaled_img"])
            b = torch.where(mask, pred[..., 4:7], cur["scaled_img"])
            return alpha, f, b
        return alpha

    def step(self, state, img, tri):
        """Feed one frame; returns (state, matte-or-None).

        Clip edges reflect like the reference's sample parser: frame 0's
        window is [f1, f0, f1], and :meth:`flush` emits the last frame's
        matte with [fN-2, fN-1, fN-2]. The matte returned by the i-th call
        (i >= 1) is for frame i-1."""
        frame = self.encode(img, tri)
        if state is None:
            return ("first", frame), None
        if state[0] == "first":
            f0 = state[1]
            return ({"k": f0["k"]}, frame), self.decode(frame, f0, frame)
        prev, cur = state
        out = self.decode(prev, cur, frame)
        # a frame that has been the window center is only read as a
        # neighbour (its key) afterwards
        return ({"k": cur["k"]}, frame), out

    def flush(self, state):
        """Emit the final frame's matte (reflected next neighbour)."""
        if state[0] == "first":       # single-frame clip
            f = state[1]
            return self.decode(f, f, f)
        prev, cur = state
        return self.decode(prev, cur, prev)
