"""Wrappers of the FAM window-attention CUDA kernel (``csrc/fam_window.cu``,
one tensor-core tile kernel: bf16 products in one pass, f32 in 3xTF32):
:func:`fam_window` (inference, no logits) and :func:`fam_window_logits`
(training, also the masked raw logits).

Their plain version is :func:`tcvom_tpu_torch.ops.fam.fam_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from tcvom_tpu_torch.ops import cuda_build

_ENTRIES = {
    (torch.float32, False): "fam_window_f32",
    (torch.bfloat16, False): "fam_window_bf16_mma",
    (torch.float32, True): "fam_window_logits_f32",
    (torch.bfloat16, True): "fam_window_logits_bf16",
}


@functools.cache
def _entry(dtype: torch.dtype, logits: bool):
    fn = getattr(cuda_build.load_library("fam_window"),
                 _ENTRIES[dtype, logits])
    fn.argtypes = ([ctypes.c_void_p] * (5 if logits else 4)
                   + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


MMA_MAX_WINDOW = 9      # the largest window the tile kernel takes


def check_mma_window(window: int) -> None:
    """Raise for a window the tile kernel does not take (every entry)."""
    if window < 1 or window % 2 == 0 or window > MMA_MAX_WINDOW:
        raise ValueError(f"the FAM kernel takes odd windows up to "
                         f"{MMA_MAX_WINDOW}, got {window}")


def _check(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
           window: int, what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")
    if k.device != q.device or mask.device != q.device:
        raise ValueError("q, k and mask must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or mask.dtype != q.dtype:
        raise ValueError(f"{what} takes f32 or bf16 q, k and mask of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {mask.dtype}")
    if q.dim() != 4 or k.shape != q.shape or \
            mask.shape != q.shape[:3] + (1,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"mask {tuple(mask.shape)}: want [B,H,W,C] twice "
                         "and [B,H,W,1]")
    if not (q.is_contiguous() and k.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    check_mma_window(window)
    if q.shape[3] < 1:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")
    # a grid of 2^31 tiles or more is refused by the C entry


def _launch(q, k, mask, window, out, logits=None):
    b, h, w, c = q.shape
    ptrs = [q.data_ptr(), k.data_ptr(), mask.data_ptr(), out.data_ptr()]
    if logits is not None:
        ptrs.append(logits.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name = "fam_window" if logits is None else "fam_window_logits"
    cuda_build.check(_entry(q.dtype, logits is not None)(
        *ptrs, b, h, w, c, window, 1.0 / math.sqrt(c), q.device.index,
        stream), name)
    cuda_build.LAUNCHES[name] += 1


def fam_window(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
               window: int) -> torch.Tensor:
    """``out = mask * sum_p softmax_p(q.k_p / sqrt(C)) k_p`` on the card.
    q, k: contiguous ``[B, H, W, C]``; mask: contiguous ``[B, H, W, 1]``;
    all three f32 or all bf16, on one CUDA device; window odd, at most
    ``MMA_MAX_WINDOW``. In bf16 the kernel rounds the softmax weights to
    bf16 as the TPU kernel does; in f32 it keeps them f32."""
    _check(q, k, mask, window, "fam_window")
    out = torch.empty_like(q)
    if q.numel():
        _launch(q, k, mask, window, out)
    return out


def fam_window_logits(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                      window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fam_window` plus the masked raw logits
    ``mask * q.k_p / sqrt(C)``, ``[B, H, W, window^2]`` in q's dtype with
    p row-major over (dy, dx); the same arguments."""
    _check(q, k, mask, window, "fam_window_logits")
    out = torch.empty_like(q)
    logits = q.new_empty(q.shape[:3] + (window * window,))
    if q.numel():
        _launch(q, k, mask, window, out, logits)
    return out, logits
