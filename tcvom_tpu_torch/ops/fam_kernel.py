"""Wrapper of the FAM window-attention CUDA kernel (``csrc/fam_window.cu``).

Its plain version is :func:`tcvom_tpu_torch.ops.fam.fam_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from tcvom_tpu_torch.ops import cuda_build

_ENTRIES = {torch.float32: "fam_window_f32", torch.bfloat16: "fam_window_bf16"}


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(cuda_build.load_library("fam_window"), _ENTRIES[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fam_window(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
               window: int) -> torch.Tensor:
    """``out = mask * sum_p softmax_p(q.k_p / sqrt(C)) k_p`` on the card.
    q, k: contiguous ``[B, H, W, C]``; mask: contiguous ``[B, H, W, 1]``;
    all three f32 or all bf16, on one CUDA device; window odd."""
    if q.device.type != "cuda":
        raise ValueError(f"fam_window needs CUDA tensors, got {q.device}")
    if k.device != q.device or mask.device != q.device:
        raise ValueError("q, k and mask must be on one device")
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or mask.dtype != q.dtype:
        raise ValueError("fam_window takes f32 or bf16 q, k and mask of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {mask.dtype}")
    if q.dim() != 4 or k.shape != q.shape or \
            mask.shape != q.shape[:3] + (1,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"mask {tuple(mask.shape)}: want [B,H,W,C] twice "
                         "and [B,H,W,1]")
    if not (q.is_contiguous() and k.is_contiguous() and mask.is_contiguous()):
        raise ValueError("fam_window takes contiguous tensors")
    if window < 1 or window % 2 == 0:
        raise ValueError(f"window must be odd and positive, got {window}")
    b, h, w, c = q.shape
    if c < 1 or b * h * w >= 2 ** 34:           # grid.x is 32 bits
        raise ValueError(f"unsupported shape {tuple(q.shape)}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cuda_build.check(_entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, w, c, window, 1.0 / math.sqrt(c), q.device.index, stream),
        "fam_window")
    cuda_build.LAUNCHES["fam_window"] += 1
    return out
