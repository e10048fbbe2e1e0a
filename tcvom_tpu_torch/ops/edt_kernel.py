"""EDT row pass: the plain version and the CUDA kernel (``csrc/edt_row.cu``).

``out[r, j] = min_{|d| <= trunc} (g2[r, j + d] + d^2)``, where positions
past either end of a row hold 1e7 (port of
tcvom_tpu/ops/edt_pallas.py::edt_row_pass_fused, which has no tiling
constraints here: any R, W and T).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tcvom_tpu_torch.ops import cuda_build

_BIG = 1.0e7
_SEG = 256                      # outputs per block, as in csrc/edt_row.cu
_MAX_SMEM = 48 * 1024           # shared memory a block gets without opt-in


def edt_row_pass_ref(g2: torch.Tensor, trunc: int) -> torch.Tensor:
    """Plain PyTorch row pass: one shifted min per offset pair."""
    r, w = g2.shape
    pad = torch.full((r, w + 2 * trunc), _BIG, dtype=g2.dtype,
                     device=g2.device)
    pad[:, trunc:trunc + w] = g2
    acc = g2.clone()
    for d in range(1, trunc + 1):
        cand = torch.minimum(pad[:, trunc - d:trunc - d + w],
                             pad[:, trunc + d:trunc + d + w]) + float(d * d)
        torch.minimum(acc, cand, out=acc)
    return acc


@functools.cache
def _entry():
    fn = cuda_build.load_library("edt_row").edt_row_pass_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def edt_row_pass_cuda(g2: torch.Tensor, trunc: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``g2`` (f32 ``[R, W]``, contiguous, on the
    card) on the current stream."""
    if g2.device.type != "cuda":
        raise ValueError(f"edt_row_pass_cuda needs a CUDA tensor, got {g2.device}")
    if g2.dtype != torch.float32 or g2.dim() != 2 or not g2.is_contiguous():
        raise ValueError("edt_row_pass_cuda takes a contiguous f32 [R, W] "
                         f"tensor, got {g2.dtype} {tuple(g2.shape)}")
    if trunc < 0 or (_SEG + 2 * trunc) * 4 > _MAX_SMEM:
        raise ValueError(f"trunc={trunc} outside [0, {(_MAX_SMEM // 4 - _SEG) // 2}]")
    r, w = g2.shape
    if r * -(-w // _SEG) >= 2 ** 31:
        raise ValueError(f"too many rows for one launch: {tuple(g2.shape)}")
    out = torch.empty_like(g2)
    if g2.numel() == 0:
        return out
    stream = torch.cuda.current_stream(g2.device).cuda_stream
    cuda_build.check(_entry()(g2.data_ptr(), out.data_ptr(), r, w, trunc,
                              g2.device.index, stream), "edt_row_pass")
    cuda_build.LAUNCHES["edt_row"] += 1
    return out


def edt_row_pass(g2: torch.Tensor, trunc: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if g2.device.type == "cpu":
        return edt_row_pass_ref(g2, trunc)
    return edt_row_pass_cuda(g2, trunc)
