"""Inference pipelines (port of tcvom_tpu/infer/predict.py).

- :class:`StreamingPredictor`: sliding-window VMN inference with cached
  per-frame features, the production matte path;
- :func:`make_vmd_eval_step` / :func:`make_single_eval_step` and
  :func:`write_pred_pngs`: the VideoMatting108 validation sweeps
  (``tools/pred_vmn.py``, ``tools/pred_single.py``);
- :class:`TestFolder` / :func:`predict_test_folder`: wild folders with real
  trimaps (``tools/pred_test.py``).
"""
from __future__ import annotations

import contextlib
import copy
import os
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from tcvom_tpu_torch.models import full_model as FM
from tcvom_tpu_torch.utils.device import resolve_device
from tcvom_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                           imread, imwrite)
from tcvom_tpu_torch.utils.trace import span

TRIMAP_DILATION = {"narrow": 5, "medium": 12, "wide": 20}  # pred_vmn.py:70-75


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _upload_batch(model, batch: dict) -> dict:
    dev = next(model.parameters()).device
    return {k: torch.as_tensor(batch[k], device=dev).float()
            for k in ("a", "fg", "bg")}


def make_vmd_eval_step(model, cfg: FM.TaskConfig, bands=None):
    """A step through FullModel_VMD without gradient: ``step(batch,
    radius=None)`` with ``a``, ``fg``, ``bg`` ``[B, S, H, W, .]`` (numpy or
    tensors, 0..255) returns (losses, center-frame alphas ``[B, H, W, 1]``,
    the center trimap visualization: 128/255 in the unknown region, the
    ground truth elsewhere). ``bands`` (``parallel.space.Bands`` of H):
    the network runs on this rank's band of every frame, the results are
    whole (``forward_vmd``)."""

    @torch.inference_mode()
    def step(batch: dict, radius=None):
        model.eval()
        batch = _upload_batch(model, batch)
        losses, aux = FM.forward_vmd(model, batch, cfg, radius, bands=bands)
        pre = aux["pre"]
        c = batch["a"].shape[1] // 2
        tris_vis = torch.where(pre["trimasks"] > 0.5, 128.0 / 255.0,
                               pre["scaled_gts"])
        return losses, aux["alphas"][:, c], tris_vis[:, c]

    return step


def make_single_eval_step(model, cfg: FM.TaskConfig):
    """As :func:`make_vmd_eval_step`, through FullModel (the center frame
    only for a single-frame model)."""

    @torch.inference_mode()
    def step(batch: dict, radius=None):
        model.eval()
        batch = _upload_batch(model, batch)
        losses, aux = FM.forward_single(model, batch, cfg, radius)
        pre = aux["pre"]
        c = batch["a"].shape[1] // 2
        if cfg.trimap_channels != 1:
            tris_vis = torch.where(pre["trimasks"] > 0.5, 128.0 / 255.0,
                                   pre["scaled_gts"])
        else:
            tris_vis = pre["tris"]
        return losses, aux["alphas"][:, c], tris_vis[:, c]

    return step


def write_pred_pngs(save_dir: str, names: list[str], alphas, tris,
                    crop_hw=(1080, 1920)):
    """Write <name>_pred.png / <name>_tri.png cropped to the original
    resolution (pred_vmn.py:125-135). ``alphas``, ``tris``: ``[B, H, W, 1]``
    in [0, 1]. ``crop_hw`` is one (h, w) for the whole batch or a list of
    per-sample (h, w) (reference pred_single.py:159-166)."""
    alphas, tris = (t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
                    for t in (alphas, tris))
    per_sample = crop_hw and not np.isscalar(crop_hw[0])
    for i, name in enumerate(names):
        h, w = crop_hw[i] if per_sample else crop_hw
        fn = os.path.splitext(name)[0]
        os.makedirs(os.path.join(save_dir, os.path.dirname(fn)), exist_ok=True)
        a = np.uint8(np.clip(alphas[i, :h, :w, 0], 0, 1) * 255)
        t = np.uint8(np.clip(tris[i, :h, :w, 0], 0, 1) * 255)
        imwrite(os.path.join(save_dir, fn + "_pred.png"), a)
        imwrite(os.path.join(save_dir, fn + "_tri.png"), t)


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
        with span("encode"):
            with span("preprocess"):
                tri_raw = torch.as_tensor(tri, device=self.device)
                img = torch.as_tensor(img, device=self.device).float()
                tri = tri_raw.float()
                pre = FM.preprocess_eval(img, tri, cfg)
                inputs = _nchw(torch.cat([pre["imgs"], pre["tris"]], dim=-1))
                # only FBA's head reads the raw image and the 2-channel trimap
                extras = ((_nchw(pre["scaled_imgs"]),
                           _nchw(pre["tris"][..., -2:]))
                          if cfg.method == "fba" else None)
                if self.dtype is not None:
                    inputs = inputs.to(self.dtype)
                    if extras is not None:
                        extras = tuple(t.to(self.dtype) for t in extras)
            enc, qkv = self.model.encode_extract_qkv(inputs, extras)
            # the paste inputs are encode's own work (no span of their own)
            out = dict(enc=type(self.model.decoder).prune_enc_head(enc),
                       trimask=_nchw(pre["trimasks"]), **qkv)
            if self.quantize:
                # quantize-then-paste commutes with paste-then-quantize, so
                # the paste runs on uint8 [B, H, W]
                s = tri_raw[..., 0].float() * FM.IMG_SCALE
                out["gt_u8"] = torch.floor(
                    torch.clamp(s, 0.0, 1.0) * 255.0).to(torch.uint8)
                if cfg.dilate_radius is None:
                    # the unknown region is pointwise in tri: 0 < tri/255 < 1
                    out["paste_gate"] = (s > 0.0) & (s < 1.0)
                else:
                    # the dilated region (preprocess_eval) keeps the
                    # network's alpha in the ring around the trimap's
                    # unknown band
                    out["paste_gate"] = pre["trimasks"][..., 0] > 0.5
            else:
                out["gt_tri"] = tri * FM.IMG_SCALE
                out["scaled_img"] = pre["scaled_imgs"]
            return out

    @torch.inference_mode()
    def decode(self, prev: dict, cur: dict, nxt: dict):
        """The matte of ``cur`` from its neighbours' keys."""
        with span("decode"):
            pred, _, _, _ = self.model.decode_window_qkv(
                cur["enc"], cur, prev["k"], nxt["k"], cur["trimask"])
            with span("paste"):
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
        with span("step"):
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
        with span("flush"):
            if state[0] == "first":       # single-frame clip
                f = state[1]
                return self.decode(f, f, f)
            prev, cur = state
            return self.decode(prev, cur, prev)


# ---------------------------------------------------------------------------
# Wild-video test folders (pred_test.py)
# ---------------------------------------------------------------------------

class TestFolder:
    """(prev, cur, next) frame triplets from NNNNN_rgb.png /
    NNNNN_trimap.png folders, edge-mirrored, zero-padded to multiples of 32
    (reference pred_test.py:17-84). Frames stay uint8."""

    def __init__(self, root: str):
        self.root = root
        names = sorted(f[:-8] for f in os.listdir(root) if f.endswith("_rgb.png"))
        if not names:
            raise FileNotFoundError(f"no *_rgb.png in {root}")
        self.names = names

    def __len__(self):
        return len(self.names)

    def _read(self, i):
        name = self.names[i]
        img = imread(os.path.join(self.root, name + "_rgb.png"), IMREAD_COLOR)
        tri = imread(os.path.join(self.root, name + "_trimap.png"),
                     IMREAD_GRAYSCALE)[..., None]
        return img, tri

    @staticmethod
    def _pad(t):
        h, w = t.shape[:2]
        return np.pad(t, ((0, (-h) % 32), (0, (-w) % 32), (0, 0)))

    def read_frame(self, i):
        """One padded frame pair ``([1, H, W, 3], [1, H, W, 1])``, the
        original (h, w) and the name: the streaming path decodes each PNG
        once."""
        img, tri = self._read(i)
        return (self._pad(img)[None], self._pad(tri)[None], img.shape[:2],
                self.names[i])

    def __getitem__(self, i):
        idxs = [max(i - 1, 0), i, min(i + 1, len(self.names) - 1)]
        imgs, tris = zip(*[self._read(j) for j in idxs])
        return {
            "imgs": np.stack([self._pad(x) for x in imgs]),
            "tris": np.stack([self._pad(x) for x in tris]),
            "orig_hw": np.asarray(imgs[0].shape[:2], np.int32),
            "name": self.names[i],
        }


def predict_test_folder(model, cfg: FM.TaskConfig, in_dir: str,
                        out_dir: str, progress: Callable | None = None,
                        dtype=None, device: str | torch.device = "cuda"
                        ) -> dict:
    """EvalModel inference over a wild folder; writes <name>_alpha.png
    (reference pred_test.py:86-116). VMN models run the streaming pipeline
    (one encode per frame, ``dtype=torch.bfloat16`` for the bf16 path);
    single-frame models run :func:`~tcvom_tpu_torch.models.full_model.
    forward_eval` on each frame triplet.

    Returns the frame count and wall seconds summed over the run by phase:
    the main loop's ``main_qget`` (waiting on the decoder thread),
    ``main_step`` (the step's host time; the device runs behind it) and
    ``main_wqput`` (queueing the matte's readback and waiting on the
    writer); the producer's ``prod_read`` (PNG decode and pad) and
    ``prod_upload`` (pinning and queueing the host-to-device copy); the
    writer's ``writer_fetch`` (waiting for the matte on the host) and
    ``writer_imwrite`` (PNG encode). Each phase is also the span
    ``tcvom.<phase>`` of a profiled run (``utils/trace.py``)."""
    dev = resolve_device(device)
    folder = TestFolder(in_dir)
    os.makedirs(out_dir, exist_ok=True)
    stats: dict = {"frames": len(folder)}

    @contextlib.contextmanager
    def phase(key):
        t0 = time.perf_counter()
        with span(key):
            yield
        # each key is written by one thread only
        stats[key] = stats.get(key, 0.0) + (time.perf_counter() - t0)

    if not cfg.is_vmn:
        if dtype is not None:
            raise ValueError("dtype selects the streaming (VMN) path's "
                             "compute type; single-frame models run in f32")
        return _predict_folder_single(model, cfg, folder, out_dir, progress,
                                      dev, phase, stats)

    # host pipeline: a bounded prefetch thread decodes frame i+k while the
    # card mattes frame i (each PNG decoded once) and uploads it; a writer
    # thread waits for each matte on the host and encodes its PNG. Both
    # copies and the network run on the default stream: a frame's upload is
    # queued before the main loop takes it from ``q``, so the encode reads
    # it after the copy lands; a matte's readback is queued right after its
    # decode and waited for on an event by the writer alone.
    cuda = dev.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=4)
    wq: queue.Queue = queue.Queue(maxsize=4)
    errors: list[Exception] = []

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if cuda else t

    def produce():
        try:
            for i in range(len(folder)):
                with phase("prod_read"):
                    img, tri, hw, name = folder.read_frame(i)
                with phase("prod_upload"):
                    img, tri = upload(img), upload(tri)
                q.put((img, tri, hw, name))
            q.put(None)
        except Exception as e:        # handed to the main loop, re-raised
            q.put(e)

    def consume():
        while True:
            item = wq.get()
            if item is None:
                return
            if errors:
                continue                # drain, so the main loop never blocks
            name, alpha, ready, (h, w) = item
            try:
                with phase("writer_fetch"):
                    if ready is not None:
                        ready.synchronize()
                    a = alpha.numpy()
                with phase("writer_imwrite"):
                    imwrite(os.path.join(out_dir, name + "_alpha.png"),
                            a[0, :h, :w])
            except Exception as e:    # re-raised after the join
                errors.append(e)

    def hand_over(out, name, hw):
        with phase("main_wqput"):
            ready = None
            if cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
                out = host
            wq.put((name, out, ready, hw))

    writer = threading.Thread(target=consume, daemon=True)
    writer.start()
    threading.Thread(target=produce, daemon=True).start()
    sp = StreamingPredictor(model, cfg, dtype=dtype, fgbg=False,
                            quantize=True, device=dev)
    try:
        state, pending, i = None, [], 0
        while True:
            with phase("main_qget"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            img, tri, hw, name = item
            with phase("main_step"):
                state, out = sp.step(state, img, tri)
            pending.append((name, hw))
            if out is not None:
                hand_over(out, *pending.pop(0))
                if progress:
                    progress(i, len(folder))
            i += 1
        if state is not None and pending:
            hand_over(sp.flush(state), *pending.pop(0))
    finally:
        wq.put(None)
        writer.join()
    if errors:
        raise errors[0]
    return stats


def _predict_folder_single(model, cfg, folder, out_dir, progress, dev, phase,
                           stats):
    if next(model.parameters()).device != dev:
        model = copy.deepcopy(model).to(dev)
    model.eval()
    for i in range(len(folder)):
        with phase("prod_read"):
            item = folder[i]
        with phase("prod_upload"):
            imgs, tris = (torch.from_numpy(item[k]).to(dev)[None].float()
                          for k in ("imgs", "tris"))
        with phase("main_step"):
            with torch.inference_mode():
                out = FM.forward_eval(model, imgs, tris, cfg)
            alphas = out[0] if isinstance(out, tuple) else out
            c = imgs.shape[1] // 2
        with phase("writer_fetch"):
            a = alphas[0, c, ..., 0].cpu().numpy()
        with phase("writer_imwrite"):
            h, w = item["orig_hw"]
            imwrite(os.path.join(out_dir, item["name"] + "_alpha.png"),
                    np.uint8(np.clip(a[:h, :w], 0, 1) * 255))
        if progress:
            progress(i, len(folder))
    return stats
