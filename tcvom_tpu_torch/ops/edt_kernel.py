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
_PER = 9            # outputs per thread, kPer in csrc/edt_row.cu
_MAX_THREADS = 1024
_MAX_SMEM = 232448  # shared memory a block may opt into on the H100 (227 KB)


def row_plan(width: int, trunc: int) -> tuple[int, int, int]:
    """``(seg, nseg, smem_bytes)`` of the kernel for rows of ``width``:
    ``nseg`` blocks a row (one unless the row needs more than 1024 threads),
    each of ``seg`` outputs (a multiple of ``_PER``, as even as that allows)
    on ``seg / _PER`` threads, staging ``seg + 2 * trunc`` values and
    ``3 * _PER`` of slack."""
    nseg = max(1, -(-width // (_PER * _MAX_THREADS)))
    seg = max(_PER, -(-(-(-width // nseg)) // _PER) * _PER)
    return seg, nseg, (seg + 2 * trunc + 3 * _PER) * 4


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
    fn = cuda_build.load_library("edt_row").edt_row_pass
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
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
    r, w = g2.shape
    seg, nseg, smem = row_plan(w, max(trunc, 0))
    if trunc < 0 or smem > _MAX_SMEM:
        raise ValueError(f"trunc={trunc} too large for W={w} (shared memory "
                         f"{smem} > {_MAX_SMEM}) or negative")
    if r * nseg >= 2 ** 31:
        raise ValueError(f"too many rows for one launch: {tuple(g2.shape)}")
    out = torch.empty_like(g2)
    if g2.numel() == 0:
        return out
    stream = torch.cuda.current_stream(g2.device).cuda_stream
    cuda_build.check(_entry()(g2.data_ptr(), out.data_ptr(), r, w, trunc,
                              seg, smem, g2.device.index, stream),
                     "edt_row_pass")
    cuda_build.LAUNCHES["edt_row"] += 1
    return out


def edt_row_pass(g2: torch.Tensor, trunc: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if g2.device.type == "cpu":
        return edt_row_pass_ref(g2, trunc)
    return edt_row_pass_cuda(g2, trunc)
