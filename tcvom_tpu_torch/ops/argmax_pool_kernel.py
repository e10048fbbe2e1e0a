"""DIM's 2x2 argmax max pool and its inverse, the max unpool: the plain
versions and the CUDA kernels (``csrc/argmax_pool.cu``).

The pool of ``[N, C, H, W]`` (H, W even) returns the pooled values and the
uint8 in-window position of each max in [0, 4), row-major, the first on
ties, as ``nn.MaxPool2d(2, 2, return_indices=True)`` picks it; the unpool
writes each value to its recorded slot of a 2x2 window and zeros to the
other three (``nn.MaxUnpool2d(2, 2)``). Both are exact, so the kernels
equal the plain versions bit for bit, in the same memory layouts: the pool
keeps a channels-last input channels-last (DIM's encoder is, from its
permuted input frame on), the unpool writes NCHW, so that the convolutions
after them round as they do after the plain ops. ``ops/image.py``
dispatches between them as ``models/layers.py::GroupNorm`` does for its
kernels: the plain ops off the card and where a gradient is needed, the
kernels on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tcvom_tpu_torch.ops import cuda_build
from tcvom_tpu_torch.ops.group_norm_kernel import needs_grad

__all__ = ["argmax_pool_cuda", "argmax_unpool_cuda", "max_pool_argmax_2x2_ref",
           "max_unpool_2x2_ref", "runs_plain"]

# outputs a thread takes where a row's width and the addresses allow it
# (csrc/argmax_pool.cu), and the alignment that asks of each tensor, in
# values of its dtype: the pool's input, its two outputs (NCHW, and
# channels-last, where a thread's run is of channels); the unpool's value
# and index inputs, its output
WIDE = 4
POOL_ALIGN = (2 * WIDE, WIDE, WIDE)
POOL_NHWC_ALIGN = (WIDE, WIDE, WIDE)
UNPOOL_ALIGN = (WIDE, WIDE, 2 * WIDE)


def runs_plain(x: torch.Tensor) -> bool:
    """Whether a pool or unpool of ``x`` runs as plain ops: off the card
    (the CPU, or the meta device of a FLOP count) or where a gradient is
    needed. On the card it calls the kernels, which raise for what they do
    not take."""
    return not x.is_cuda or needs_grad(x)


def max_pool_argmax_2x2_ref(x: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: the pool of ``[N, C, H, W]``, (pooled, idx)."""
    n, c, h, w = x.shape
    xv = x.view(n, c, h // 2, 2, w // 2, 2)
    a, b = xv[:, :, :, 0, :, 0], xv[:, :, :, 0, :, 1]
    d, e = xv[:, :, :, 1, :, 0], xv[:, :, :, 1, :, 1]
    # each pair keeps its first element unless the second is larger, and
    # the second pair wins only if strictly larger: the first max overall
    top, bottom = torch.maximum(a, b), torch.maximum(d, e)
    idx = torch.where(bottom > top, (e > d).to(torch.uint8) + 2,
                      (b > a).to(torch.uint8))
    return torch.maximum(top, bottom), idx


def max_unpool_2x2_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the unpool of ``[N, C, h, w]`` to ``[N, C, 2h, 2w]``."""
    n, c, h, w = x.shape
    slot = torch.arange(4, dtype=idx.dtype, device=idx.device).view(
        1, 1, 1, 2, 1, 2)
    out = torch.where(idx[:, :, :, None, :, None] == slot,
                      x[:, :, :, None, :, None], 0.0)
    return out.reshape(n, c, 2 * h, 2 * w)


@functools.cache
def _entries():
    """The C entries: the pool of an NCHW and of a channels-last tensor,
    the unpool."""
    lib = cuda_build.load_library("argmax_pool")
    entries = (lib.argmax_pool_forward, lib.argmax_pool_forward_nhwc,
               lib.argmax_unpool_forward)
    for fn, sizes in zip(entries, (2, 3, 2)):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * sizes
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return entries


def _refusal(x: torch.Tensor) -> str | None:
    """Why the kernels do not take ``x``; None when they do."""
    if not x.is_cuda:
        return f"needs a CUDA tensor, got {x.device}"
    if x.dtype not in (torch.float32, torch.bfloat16):
        return f"takes f32 or bf16, got {x.dtype}"
    if x.dim() != 4:
        return f"takes [N, C, H, W], got {tuple(x.shape)}"
    if needs_grad(x):
        return "has no backward, and a gradient is needed"
    return None


def _vec(width: int, tensors, align) -> int:
    """:data:`WIDE` where each run of ``width`` outputs (a row, or a
    pixel's channels) splits into whole runs of it and every tensor's
    address allows the wide loads, else 1."""
    ok = width % WIDE == 0 and all(
        t.data_ptr() % (a * t.element_size()) == 0
        for t, a in zip(tensors, align))
    return WIDE if ok else 1


def _launch(entry, name: str, args, dtype: torch.dtype, vec: int,
            device: int) -> None:
    """One launch of a C entry: its pointers and sizes, then the dtype's
    flag, the vector width, the device and its current stream."""
    cuda_build.check(entry(*args, dtype == torch.bfloat16, vec, device,
                           torch._C._cuda_getCurrentRawStream(device)), name)
    cuda_build.LAUNCHES[name] += 1


def argmax_pool_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, idx) of ``[N, C, H, W]`` by one launch of
    ``argmax_pool_fwd`` (an NCHW tensor) or ``argmax_pool_fwd_nhwc`` (a
    channels-last one, whose outputs are channels-last too), after raising
    for tensors it does not take or that need a gradient (an input of
    another layout is made contiguous first)."""
    why = _refusal(x)
    if why is None and (x.shape[-2] % 2 or x.shape[-1] % 2):
        why = f"takes even H and W, got {tuple(x.shape)}"
    if why is not None:
        raise ValueError(f"argmax_pool_cuda {why}")
    nhwc = (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))
    if not nhwc:
        x = x.contiguous()
    n, c, h, w = x.shape
    layout = torch.channels_last if nhwc else torch.contiguous_format
    y = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=x.device,
                    memory_format=layout)
    idx = torch.empty(y.shape, dtype=torch.uint8, device=x.device,
                      memory_format=layout)
    if not x.numel():
        return y, idx
    ptrs = (x.data_ptr(), y.data_ptr(), idx.data_ptr())
    if nhwc:
        entry, sizes = _entries()[1], (n * h // 2, w // 2, c)
        vec = _vec(c, (x, y, idx), POOL_NHWC_ALIGN)
    else:
        entry, sizes = _entries()[0], (n * c * h // 2, w)
        vec = _vec(w // 2, (x, y, idx), POOL_ALIGN)
    _launch(entry, "argmax_pool_fwd", ptrs + sizes, x.dtype, vec,
            x.get_device())
    return y, idx


def argmax_unpool_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The unpool of ``[N, C, h, w]`` with its uint8 ``idx`` to an NCHW
    ``[N, C, 2h, 2w]`` by one launch of ``argmax_pool_unpool``, after
    raising for tensors it does not take or that need a gradient (inputs of
    another layout, such as a channels-last index, are made contiguous
    first)."""
    why = _refusal(x)
    if why is None and (idx.dtype != torch.uint8 or idx.shape != x.shape
                        or idx.device != x.device):
        why = (f"takes a uint8 index of x's shape and device, got "
               f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    if why is not None:
        raise ValueError(f"argmax_unpool_cuda {why}")
    x, idx = x.contiguous(), idx.contiguous()
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if x.numel():
        vec = _vec(w, (x, idx, out), UNPOOL_ALIGN)
        _launch(_entries()[2], "argmax_pool_unpool",
                (x.data_ptr(), idx.data_ptr(), out.data_ptr(), n * c * h, w),
                x.dtype, vec, x.get_device())
    return out
