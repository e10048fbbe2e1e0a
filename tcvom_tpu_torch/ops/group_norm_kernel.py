"""GroupNorm with the activation that follows it and an optional residual
added before that activation: the plain version and the CUDA kernel
(``csrc/group_norm.cu``).

``y = act(F.group_norm(x, groups, weight, bias, eps) + residual)``, the
residual left out when it is None, ``act`` one of :data:`ACTS`: None, ReLU
or FBA's LeakyReLU(0.01). The plain version, :func:`group_norm_ref`, is that
composition op for op; the kernel computes it in f32 and rounds once to
``x``'s dtype (bf16 or f32), where the plain composition in bf16 rounds
after the norm and again after the add.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tcvom_tpu_torch.ops import cuda_build

ACTS = {None: 0, "relu": 1, "leaky_relu": 2}    # the kernel's act codes
LEAKY_SLOPE = 0.01                               # FBA's LeakyReLU
# The plan: statistics blocks per SM aimed at (at the kernel's 55
# registers a thread four fit an SM: one wave, each block reading long
# runs; 4 read 61-80 % of the bytes bound at FBA's shapes on the H100,
# 2, 8 and 16 less), the least bytes one reads, the most bytes of x one
# apply block reads, and the most blocks a group or a channel takes
STATS_BLOCKS_PER_SM = 4
SPLIT_BYTES = 32 * 1024
TILE_BYTES = 32 * 1024
MAX_PARTS = 1 << 16


def epilogue(y: torch.Tensor, act: str | None,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(y + residual)``, in ``y``'s dtype, as separate ops."""
    if residual is not None:
        y = y + residual
    if act is None:
        return y
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, LEAKY_SLOPE)
    raise ValueError(f"act must be one of {list(ACTS)}, got {act!r}")


def group_norm_ref(x: torch.Tensor, groups: int,
                   weight: torch.Tensor | None, bias: torch.Tensor | None,
                   eps: float, act: str | None = None,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch: ``F.group_norm``, then :func:`epilogue`."""
    return epilogue(F.group_norm(x, groups, weight, bias, eps), act,
                    residual)


def plan(n: int, channels: int, hw: int, groups: int, itemsize: int,
         sms: int) -> tuple[int, int]:
    """``(splits, tiles)`` of the kernel for ``[n, channels, hw]``: the
    statistics blocks of each (sample, group), as many as put
    ``STATS_BLOCKS_PER_SM`` on each of ``sms`` SMs but none reading under
    ``SPLIT_BYTES``; the apply blocks of each (sample, channel), none
    reading over ``TILE_BYTES`` of x."""
    group_bytes = channels // groups * hw * itemsize
    splits = min(-(-sms * STATS_BLOCKS_PER_SM // (n * groups)),
                 group_bytes // SPLIT_BYTES, MAX_PARTS)
    tiles = min(-(-hw * itemsize // TILE_BYTES), MAX_PARTS)
    return max(1, splits), max(1, tiles)


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd would need a gradient through these tensors (the
    kernel has no backward)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def runs_plain(x: torch.Tensor, *tensors: torch.Tensor | None) -> bool:
    """Whether a norm of ``x`` (with these other tensors) runs as plain
    ops: on the CPU, or where a gradient is needed. Everywhere else it
    calls :func:`group_norm_cuda`, which raises for what it cannot take."""
    return x.device.type == "cpu" or needs_grad(x, *tensors)


def _refusal(x: torch.Tensor, groups: int, weight: torch.Tensor | None,
             bias: torch.Tensor | None,
             residual: torch.Tensor | None) -> str | None:
    """Why the kernel does not take these tensors; None when it does."""
    if not x.is_cuda:
        return f"needs a CUDA tensor, got {x.device}"
    if x.dtype not in (torch.float32, torch.bfloat16):
        return f"takes f32 or bf16, got {x.dtype}"
    if x.dim() < 2 or not x.is_contiguous() or x.data_ptr() % 16:
        return (f"takes a contiguous [N, C, *] tensor at a 16-byte aligned "
                f"address, got {tuple(x.shape)} strides {x.stride()}")
    if groups < 1 or x.shape[1] % groups:
        return f"{x.shape[1]} channels do not split into {groups} groups"
    device = x.get_device()
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and (p.get_device() != device or p.dtype != x.dtype
                              or p.shape != x.shape[1:2]
                              or not p.is_contiguous()):
            return (f"{name} must be a contiguous [C] tensor of x's dtype "
                    f"and device, got {p.dtype} {tuple(p.shape)}")
    if residual is not None and (
            residual.get_device() != device or residual.dtype != x.dtype
            or residual.shape != x.shape or not residual.is_contiguous()
            or residual.data_ptr() % 16):
        return (f"residual must be contiguous, 16-byte aligned and of x's "
                f"shape, dtype and device, got {residual.dtype} "
                f"{tuple(residual.shape)}")
    return None


@functools.lru_cache(maxsize=256)
def _plan(n: int, channels: int, hw: int, groups: int, itemsize: int,
          index: int) -> tuple[int, int]:
    return plan(n, channels, hw, groups, itemsize,
                torch.cuda.get_device_properties(index).multi_processor_count)


@functools.cache
def _entry():
    fn = cuda_build.load_library("group_norm").group_norm_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, groups: int, weight: torch.Tensor | None,
            bias: torch.Tensor | None, eps: float, act: str | None,
            residual: torch.Tensor | None) -> torch.Tensor:
    """The two kernels (statistics, apply) on the current stream, for
    tensors :func:`group_norm_cuda` has checked."""
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n, c = x.shape[:2]
    hw = x.numel() // (n * c)
    index = x.get_device()
    splits, tiles = _plan(n, c, hw, groups, x.element_size(), index)
    partials = torch.empty((n * groups, splits, 3), dtype=torch.float32,
                           device=x.device)
    cuda_build.check(_entry()(
        x.data_ptr(), None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        partials.data_ptr(), n, c, hw, groups, eps, ACTS[act],
        x.dtype == torch.bfloat16, splits, tiles, index,
        # the stream PyTorch's current_stream() wraps, without the wrapper
        torch._C._cuda_getCurrentRawStream(index)), "group_norm")
    cuda_build.LAUNCHES["group_norm_stats"] += 1
    cuda_build.LAUNCHES["group_norm_apply"] += 1
    return out


def group_norm_cuda(x: torch.Tensor, groups: int,
                    weight: torch.Tensor | None, bias: torch.Tensor | None,
                    eps: float, act: str | None = None,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(F.group_norm(x, groups, weight, bias, eps) + residual)`` by
    the two kernels, after raising for tensors they do not take or that
    need a gradient."""
    why = _refusal(x, groups, weight, bias, residual)
    if why is None and needs_grad(x, weight, bias, residual):
        why = "has no backward, and a gradient is needed"
    if why is None and act not in ACTS:
        why = f"act must be one of {list(ACTS)}, got {act!r}"
    if why is not None:
        raise ValueError(f"group_norm_cuda {why}")
    return _launch(x, groups, weight, bias, eps, act, residual)
