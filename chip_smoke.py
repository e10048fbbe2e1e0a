#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tcvom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]

From the repo root, on a machine with a CUDA card and the CUDA toolkit:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: the CUDA kernels from tcvom_tpu_torch/csrc, with ptxas's
   register and shared-memory report and each kernel's SASS instruction
   count;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (EDT row pass bit-exact; both FAM entries, out and
   logits, f32 to 1e-5, bf16 to 2e-2; GroupNorm with each of the main
   path's epilogues, bf16, to 2^-7 (1 + |value|) of the f32 composition), with
   CUDA-event times and the card's bound for the same work (GroupNorm's
   two kernels also apart, by the profiler, each beside its own bytes
   bound, and PyTorch's F.group_norm as its library time; DIM's argmax
   pool and unpool bit for bit at its five levels, bf16 and f32, each
   kernel's device time beside its bytes bound and the plain ops');
4. the main path in f32 at full width (vmn_fba, 1088x1920, window 7,
   random weights from a seed): once through the kernels, once with the
   plain versions substituted; the uint8 mattes agree within one level;
   the decode's time;
5. the main path in bf16, as users run it: the launch counts must equal
   the encodes (EDT) and decodes (FAM), and the GroupNorm kernels' each
   GroupNorm call (FBA_NORMS a frame); known trimap pixels pasted
   exactly; the uint8 mattes against the plain versions' within
   BF16_STREAM (calibrated below); steady-state times and memory;
6. the evaluation tools, on files in a temporary folder under build/:
   pred_test's predict_test_folder in bf16 on 8 PNG frames of 1080x1920
   (launches, pasted pixels, mattes within BF16_STREAM of the plain
   versions', fps end to end beside the step's, the host pipeline's time
   per frame, the PNG codec); pred_vmn on a fake VideoMatting108 clip of 4
   frames (f32, 1088x1920, B = 1, S = 3, medium trimaps; launches, finite
   losses, the PNGs written, the sweep's phases); calc_metric on its
   output on the card and on the CPU (every number within rtol 1e-5), and
   on the card with --vis (one captioned image a frame, metric.json
   unchanged);
7. train_kernels: both FAM entries against the plain version at the
   training path's and pred_vmn's shapes (f32 to 1e-5, bf16 to 2e-2), the
   autograd Function's dq, dk against the plain version's autograd, and
   its times; the EDT row pass bit-exact at the inputs make_trimap gives it
   in the train and validation steps and in pred_vmn, with its times at
   the train step's and pred_vmn's;
8. train_f32: the video trainer at full width and depth (vmn_fba, B=1,
   S=5, 512x512, Adam, poly lr 1e-4, weight decay 1e-4, synthetic seeded
   clips): one step through the kernels against one through the plain
   versions (losses, gradients, launch counts), five more steps (finite
   losses, ms, peak memory) and one validation step (B=6, S=3, 544x960);
9. fam_c32, fam_c128: both FAM entries at IndexNet's width, [2, 136,
   240, 32], and at GCA's, [2, 136, 240, 128], against the plain version,
   timed by the profiler's device time (at C = 32 a launch runs shorter
   than its call from Python takes; the CUDA-event time is printed
   beside), with their bounds;
10. the DIM, IndexNet and GCA streams (vmn_dim, FAM at C = 256;
   vmn_index, C = 32; vmn_gca, C = 128; all 1088x1920, window 7, random
   weights from seed 0, GCA's spectral-norm u and v set to its weights'
   leading singular vectors; no EDT: their trimaps are one channel or a
   one-hot): main_<name>_f32 (4 frames, kernels against plain versions
   within one level, >= 99.9 % identical) and main_<name>_bf16 (12
   frames, against the plain versions within BF16_BACKBONE, beside what
   the TPU kernel's own bf16 weights move the stream by), each with
   launches {"fam_window": n}, known pixels pasted exactly and the share
   of unknown pixels strictly between 0 and 255 (under 1 %, the weights
   are calibrated first: calibrate_random_weights); times and memory; for
   GCA the attention core's own time;
11. pred_single --model dim and --model gca on pred_vmn's clip (f32;
   finite mSAD and MSE, the PNGs, seconds per sample, no kernel launched)
   and pred_vmn --model index and --model gca on it (f32; one
   fam_window_logits launch per sample, finite losses, the PNGs, at least
   LIVE_SHARE of the mattes' pixels strictly between 0 and 255); then
   pred_single --model fba --dataset adobe on two stills of
   Composition-1k's size (pred_single_adobe_phase): at the tool's
   defaults, the 800x800 resize grid, with --vis, and at --val_mode
   origin, the 2112x2112 grid (one edt_row launch a sample, finite mSAD
   and MSE, the PNGs at the JAX tool's crops, the captioned images), with
   kernel A bit-exact at each run's captured row-pass input, [4800, 800]
   and [12672, 2112], and timed there;
12. the logits kernel (C/D) at the other backbones' training and
   validation batches ([24, 64, 64, 256], [24, 64, 64, 32], [36, 64, 64,
   128], [12, 68, 120, 32], [12, 68, 120, 128]) against the plain version,
   out, logits, dq and dk, with the profiler's device time;
13. train_dim_f32, train_index_f32, train_gca_f32: the video trainer of
   each at full published width as its cfgs/vmd_vmn_*_pretrained_30ep.yaml
   sets it (B = 4, 4, 6; S = 5, 512x512, f32), random weights from seed 0:
   a kernel step against a plain step (losses, each module's gradient,
   BatchNorm statistics, u, v; see train_backbone_phase), four more
   steps (ms, peak memory) and a validation step (B = 6, S = 3, 544x960),
   one fam_window_logits launch each;
14. train_cli: python -m tcvom_tpu_torch.tools.train in subprocesses on
   fake trees under build/: the IndexNet video config for an epoch,
   resumed for a second, and the GCA TAM pretrain on Adobe-DIM stills,
   whose frozen backbone must come out as it was loaded; seconds a step
   and the loader's wait;
15. train_ddp_fba, train_ddp_gca2, pred_vmn_ddp: tools.train and
   tools.pred_vmn under python -m torch.distributed.run --standalone
   (train_ddp_phases, pred_vmn_ddp_phase): FBA's video config at full
   width on one rank over NCCL against the plain command, an epoch and
   its validation (losses, validation L_dt, weights, best.pth), GCA's at
   B = 6 on two ranks over gloo on the one card against one process at
   B = 12 (losses, statistics, the whole update and each module's
   against jittered one-process steps), pred_vmn on two gloo ranks
   against a one-process sweep (the PNGs byte for byte, each rank's
   launches; the one-process runs here take a fresh process's TF32
   settings, which the tools' subprocesses keep: cuDNN's convolutions in
   TF32); the DDP step's ms beside the plain step's, each rank's peak
   memory; then pred_vmn_space (check_fam_band, pred_vmn_space_phase):
   kernel D at a --space 2 band of the 1088x1920 grid plus its halo,
   [2, 71, 240, C] and [2, 72, 240, C] at C = 256 (FBA, DIM), 32
   (IndexNet) and 128 (GCA), bit for bit the whole grid's call cropped,
   timed; pred_vmn --space 2 with each of the four models on two gloo
   ranks of the one card against the one-process sweeps (PNGs within one
   level and >= 99.9 % identical, loss.log within rtol 1e-4; DIM and GCA
   within twice what a rounding-size jitter of their weights moves their
   one-process sweeps where that is more; each rank's launches, band,
   step and peak, the band exchanges a sample);
16. train_<name>_bf16, train_<name>_remat (fba, dim, index, gca, as in
   8 and 13) and train_cli_bf16_remat: TRAIN.BF16 (the JAX recipe: f32
   arithmetic on bf16-rounded weights, state and batch) over five steps,
   at each f32 state the bf16 step beside the f32 step (loss error, raw
   gradient and Adam update cosines) and the bf16 trajectory beside the
   f32 one, held to BF16_GATES (JAX's own guard), with ms, peak memory,
   launches (no bf16 logits kernel) and the f32 dtypes of what it keeps;
   --remat: two plain steps and one remat step from one state, remat
   within twice the plain steps' spread (at least 1e-6), its peak below
   the plain step's; tools.train --remat TRAIN.BF16 True for an epoch of
   IndexNet's video config on train_cli's tree.

The run adopts the orphans of every process it starts (a subreaper on
Linux) and, when it ends, passed or failed, ends what is still running
and reaps it (stop_children): the spawned DataLoader's resource tracker,
which otherwise outlives this process by a second or more, and a tool's
tracker orphaned when the tool exits; the "stop" line lists what was
still running then and what had to be killed.

The line before the last lists every kernel row on every path that runs
it (name, route, source, the TPU kernel it replaces, the path, launches
on that path, error, ms, plain ms, bound); the last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
``--profile FILE`` adds torch.profiler breakdowns of two bf16 stream
steps of each backbone, one pred_vmn evaluation step and two train steps
of each trainer, their tables written to FILE. The device phase prints
the versions of OpenCV and PyYAML (None where one does not import).
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import functools
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock as mock
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H, W, WINDOW = 1088, 1920, 7
FRAME_HW = (1080, 1920)                       # the tools' frames, padded to H
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
# The bf16 stream's uint8 mattes, kernels against plain versions (12 frames,
# 1088x1920, seed 0). Baseline: the earlier FAM kernel, which kept its
# softmax weights in f32, gave at most 14 levels and 99.916 % identical. The
# tensor-core kernel rounds its weights to bf16, as the TPU kernel does
# (tcvom_tpu/ops/fam_pallas.py:249); the plain path given that same
# rounding moved this stream by at most 30 levels and left 97.979 %
# identical (measured once on the H100, PERF.md). The margin over the
# baseline (+18 levels, -2.4 points) admits the TPU kernel's own precision
# with ~2 levels and ~0.5 points to spare; a fault in the kernel moves far
# more.
BF16_STREAM = {"max_level_diff": 32, "identical_share": 0.975}
# The bf16 streams of vmn_dim and vmn_index, kernels against plain versions
# (12 frames, 1088x1920, seed 0). Each run prints beside it what the TPU
# kernel's own rounding (its softmax weights in bf16, the plain path given
# that rounding) moves the same stream by (phase tpu_rounding_<name>). DIM
# (calibrated weights) is moved by it at most 6 levels, 96.364 % identical,
# and by the kernel 5 levels, 96.495 % (measured once on the H100, PERF.md):
# its limit admits the TPU kernel's own precision with 2 levels and ~0.5
# points to spare, as BF16_STREAM does for FBA. IndexNet's stream (1 level,
# 99.9994 % from the TPU's rounding) stays within BF16_STREAM, and so does
# GCA's (1 level, 99.850 % from the TPU's rounding; the kernel 1 level,
# 99.981 %; measured once on the H100, PERF.md).
BF16_BACKBONE = {"dim": {"max_level_diff": 8, "identical_share": 0.958},
                 "index": BF16_STREAM, "gca": BF16_STREAM}
# share of the mattes' pixels that must lie strictly between 0 and 255
# before a comparison of mattes says something: of the trimaps' unknown
# pixels (trimap 128) in the streams (unknown_share), of every pixel of the
# pred PNGs in the pred_vmn sweeps (live_share)
LIVE_SHARE = 0.01
# vmn_fba's GroupNorms at depth (3, 4, 6, 3): 59 in the per-frame half
# (encoder and extract), 2 in the head; a forward with no gradient runs
# each through the two group_norm kernels once (a stream step: an encode
# and a decode). In pred_vmn --space only the PPM's 4 run whole on every
# rank (parallel.space.whole), and so through the kernels.
FBA_NORMS = 61
FBA_PPM_NORMS = 4
PEAK_OPS = {torch.float32: 67e12,             # f32 outside the tensor cores
            torch.bfloat16: 989e12,           # bf16 tensor cores, dense
            # an add or a min is one operation in one issue slot (the 67
            # TFLOP/s above count a fused multiply-add as two): 132 SMs x
            # 128 lanes x 1.98 GHz
            "f32 add/min": 132 * 128 * 1.98e9}
# The EDT row pass's least exact algorithm: a min-plus convolution with the
# convex kernel d^2 (|d| <= T), done by a lower-envelope or monotone-argmin
# pass in which each value enters and leaves the envelope once: a few adds,
# a divide and compares each, counted high as 16 operations an output.
EDT_OPS_PER_OUTPUT = 16


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


T_START = time.perf_counter()


def emit(**kw):
    """One JSON line, with ``t``: seconds since the script started."""
    print(json.dumps(dict(kw, t=round(time.perf_counter() - T_START, 1))),
          flush=True)


PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> bool:
    """Makes this process the reaper of its descendants' orphans (Linux
    prctl), so that stop_children finds every process the run started,
    one whose parent has exited included. Returns whether it took."""
    import ctypes

    try:
        return ctypes.CDLL(None).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0,
                                       0) == 0
    except (OSError, AttributeError):
        return False


def live_children() -> dict[int, str]:
    """This process's children that have not exited: pid -> command."""
    me, out = str(os.getpid()), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
            cmd = Path(f"/proc/{d}/cmdline").read_bytes()
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if ppid == me and state != "Z":
            out[int(d)] = cmd.replace(b"\0", b" ").decode(errors="replace")
    return out


def stop_children(grace_s: float = 30.0) -> dict:
    """Ends what the run left running and reaps it: multiprocessing's
    children (loader workers), its resource tracker (which a spawned
    DataLoader starts, and which ends only once every holder of its pipe
    has exited), then waits up to ``grace_s`` for the other children
    (adopted orphans) and kills those still alive. Returns the commands
    still running when it was called, and those it killed."""
    import gc
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker

    running = sorted(live_children().values())
    gc.collect()
    for p in multiprocessing.active_children():
        p.terminate()
        p.join(10)
    # the tracker's own stop (private): closes its pipe and waits for it
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            if not os.waitpid(-1, os.WNOHANG)[0]:
                time.sleep(0.05)
        except ChildProcessError:                   # no children at all
            return {"running": running, "killed": []}
    killed = live_children()
    for pid in killed:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    with contextlib.suppress(ChildProcessError):
        while True:
            os.waitpid(-1, 0)
    return {"running": running, "killed": sorted(killed.values())}


def time_ms(fn, iters: int) -> float:
    """CUDA-event time per call over ``iters`` warm calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_MS_TRIES = 3


def device_ms(fn, iters: int, kernel: str) -> float:
    """Device time per call of the kernels whose name holds ``kernel``,
    by torch.profiler, over ``iters`` warm calls: for a kernel shorter
    than its launch from Python, where CUDA events between launches time
    the host. A session that records none of the kernel's device time is
    profiled again (the profiler once missed it on an H100 whose every
    earlier run had it), up to ``DEVICE_MS_TRIES`` sessions."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, DEVICE_MS_TRIES + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events if kernel in e.key)
        if us:
            return us / iters / 1e3
        print(f"chip_smoke: profiler session {attempt} saw no device time "
              f"of {kernel} ({len(events)} device events: "
              f"{[e.key[:60] for e in events[:4]]})", file=sys.stderr,
              flush=True)
    fail(f"the profiler saw no device time of {kernel} in "
         f"{DEVICE_MS_TRIES} sessions")


def host_ms(fn, iters: int) -> float:
    """Host-clock time per call, fenced by torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sass_counts(lib) -> dict[str, int]:
    """Instructions (NOPs left out) of each kernel in the built library
    ``lib``, by demangled name, from ``cuobjdump -sass``."""
    import re
    cuda_bin = "/usr/local/cuda/bin"
    sass = subprocess.run([f"{cuda_bin}/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)", line):
            counts[name] += 1
    names = subprocess.run([f"{cuda_bin}/cu++filt"], input="\n".join(counts),
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.splitlines()
    return dict(zip(names, counts.values()))


def with_norms(counts: dict, calls: int) -> dict:
    """``counts`` with each GroupNorm kernel launched ``calls`` times."""
    return (dict(counts, group_norm_stats=calls, group_norm_apply=calls)
            if calls else dict(counts))


def with_pools(counts: dict, name: str, encodes: int, heads: int) -> dict:
    """``counts`` with DIM's pool and unpool kernels where ``name`` is
    DIM: five pools and two unpools a call of the encoder and the extract
    half, three unpools a call of the head."""
    if name != "dim":
        return dict(counts)
    return dict(counts, argmax_pool_fwd=5 * encodes,
                argmax_pool_unpool=2 * encodes + 3 * heads)


def plain_kernels(fam, edt_kernel, group_norm: bool = True):
    """A context in which the kernels' plain versions stand in for them
    (GroupNorm's: the layer's plain ops; DIM's pool and unpool: theirs).
    Without ``group_norm`` the GroupNorm kernels stay: for the bf16
    streams' holds against
    BF16_STREAM, which FBA's random weights would otherwise fail on any
    change of GroupNorm's rounding (PERF.md, kernel E)."""
    import contextlib

    from tcvom_tpu_torch.ops import argmax_pool_kernel, group_norm_kernel

    def plain_fam(q, k, mask, window, need_logits=False):
        out, lg = fam.fam_attention_ref(q, k, mask, window)
        return out, (lg if need_logits else None)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fam, "fam_attention", plain_fam))
    stack.enter_context(mock.patch.object(edt_kernel, "edt_row_pass",
                                          edt_kernel.edt_row_pass_ref))
    stack.enter_context(mock.patch.object(
        argmax_pool_kernel, "argmax_pool_cuda",
        argmax_pool_kernel.max_pool_argmax_2x2_ref))
    stack.enter_context(mock.patch.object(
        argmax_pool_kernel, "argmax_unpool_cuda",
        argmax_pool_kernel.max_unpool_2x2_ref))
    if group_norm:
        stack.enter_context(mock.patch.object(
            group_norm_kernel, "group_norm_cuda",
            group_norm_kernel.group_norm_ref))
    return stack


def run_plain_stream(sp, frames, fam, edt_kernel, cuda_build,
                     group_norm: bool = True):
    """The stream through the plain versions of the kernels (see
    ``plain_kernels``); it must launch none, or only the GroupNorm
    kernels' FBA_NORMS a frame where they stay."""
    cuda_build.LAUNCHES.clear()
    with plain_kernels(fam, edt_kernel, group_norm):
        outs = run_stream(sp, frames)
    want = with_norms({}, 0 if group_norm else len(frames) * FBA_NORMS)
    if dict(cuda_build.LAUNCHES) != want:
        fail(f"a plain run launched kernels: {dict(cuda_build.LAUNCHES)}, "
             f"want {want}")
    return outs


def hold_stream(phase, want, got, **extra):
    """uint8 mattes ``got`` (kernels) against ``want`` (plain versions): the
    largest level difference, the identical share and the histogram of
    differences, emitted."""
    diff = torch.stack([(g.int() - w.int()).abs() for g, w in zip(got, want)])
    same = (diff == 0).float().mean().item()
    emit(phase=phase, mattes=len(got), **extra,
         max_level_diff=diff.max().item(), identical_share=same,
         level_diff_hist=torch.bincount(diff.flatten()).tolist()[:32])
    return diff.max().item(), same


def make_frames(n: int, seed: int = 0):
    """Noise frames with the trimap of bench.py moved per frame, uint8 on
    the card."""
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        img = rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8)
        tri = np.zeros((1, H, W, 1), np.uint8)
        dy, dx = rng.randint(-16, 17, 2)
        tri[:, 300 + dy:800 + dy, 500 + dx:1400 + dx] = 128
        tri[:, 450 + dy:650 + dy, 700 + dx:1200 + dx] = 255
        frames.append((torch.from_numpy(img).cuda(),
                       torch.from_numpy(tri).cuda()))
    return frames


def run_stream(sp, frames):
    state, outs = None, []
    for img, tri in frames:
        state, out = sp.step(state, img, tri)
        if out is not None:
            outs.append(out)
    outs.append(sp.flush(state))
    torch.cuda.synchronize()
    return outs


def check_mattes(outs, frames, what: str):
    """uint8 [1, H, W] mattes with the trimap's known pixels pasted
    exactly."""
    for out, (_, tri) in zip(outs, frames):
        if out.shape != (1, H, W) or out.dtype != torch.uint8:
            fail(f"{what} matte {tuple(out.shape)} {out.dtype}")
        t = tri[..., 0]
        known = (t == 0) | (t == 255)
        if not torch.equal(out[known], t[known]):
            fail(f"{what} matte: known pixels differ from the trimap")


def unknown_share(outs, frames) -> float:
    """Share of the trimaps' unknown pixels whose matte lies strictly
    between 0 and 255."""
    inside = total = 0
    for out, (_, tri) in zip(outs, frames):
        o = out[tri[..., 0] == 128]
        inside += ((o > 0) & (o < 255)).sum().item()
        total += o.numel()
    return inside / total


def fam_ref_tpu_weights(q, k, mask, window: int, need_logits=False):
    """The plain FAM with its softmax weights rounded to q's dtype before
    the weighted sum, as the TPU kernel rounds them
    (tcvom_tpu/ops/fam_pallas.py:249): in bf16, the TPU kernel's own
    effect on a stream."""
    b, h, w, c = q.shape
    r = window // 2
    qf, kp = q.float(), torch.nn.functional.pad(k.float(),
                                                (0, 0, r, r, r, r))
    shifted = [kp[:, r + dy:r + dy + h, r + dx:r + dx + w]
               for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    logits = torch.stack([(qf * ks).sum(-1) for ks in shifted], -1) / c ** 0.5
    att = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = sum(att[..., p:p + 1] * ks for p, ks in enumerate(shifted))
    return (out * mask.float()).to(q.dtype), None


def hold_edt(edt_kernel, x, t: int, timed: bool = False, **where):
    """Kernel A against its plain version at ``x`` [R, W], truncation
    ``t``: bit-exact. With ``timed``, its CUDA-event time, the plain
    version's and the bound, returned; the brute-force loop's own ceiling
    (3T operations an output at one per issue slot) is emitted beside."""
    want = edt_kernel.edt_row_pass_ref(x, t)
    got = edt_kernel.edt_row_pass_cuda(x, t)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    emit(phase="check", kernel="edt_row", **where, shape=list(x.shape),
         trunc=t, tolerance="bit-exact", max_abs_err=err)
    if not torch.equal(got, want):
        fail(f"edt_row {tuple(x.shape)} T={t}: not bit-exact, max err {err}")
    if not timed:
        return None
    ms = time_ms(lambda: edt_kernel.edt_row_pass_cuda(x, t), 20)
    plain_ms = time_ms(lambda: edt_kernel.edt_row_pass_ref(x, t), 3)
    r, w = x.shape
    b_ms, b_by = bound(2 * r * w * 4, EDT_OPS_PER_OUTPUT * r * w,
                       "f32 add/min")
    res = dict(shape=list(x.shape), dtype=str(x.dtype), max_abs_err=err,
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    emit(phase="time", kernel="edt_row", **where, trunc=t, **res,
         loop_ceiling_ms=3 * t * r * w / PEAK_OPS["f32 add/min"] * 1e3)
    return res


def check_edt(edt_kernel, distance, tri):
    """Kernel A at the serving path's input (the column pass of this
    frame's bg/fg planes, [2*1088, 1920], T = 256), timed, and at a ragged
    shape."""
    seeds = torch.stack([tri[0, ..., 0] == 0, tri[0, ..., 0] == 255])
    g = distance._dist1d_along_axis(seeds, axis=1, truncate=256)
    g2 = torch.clamp_max(g * g, 1e7).reshape(-1, W).contiguous()
    rng = np.random.RandomState(1)
    ragged = torch.from_numpy(np.where(
        rng.rand(130, 70) < 0.05, 0.0,
        rng.randint(0, 3000, (130, 70))).astype(np.float32)).cuda()
    hold_edt(edt_kernel, ragged, 32)
    return hold_edt(edt_kernel, g2, 256, timed=True, path="serve")


def check_edt_train(edt_kernel):
    """Kernel A at the inputs make_trimap gives it: the column pass of the
    train batch's bg/fg planes ([B*S*2*512, 512]), timed, of the validation
    batch's ([B*S*2*544, 960]), of the DDP validation's at B = 1, timed,
    and of a pred_vmn sample's at the medium trimap width ([1*3*2*1088,
    1920]), timed, captured from preprocess with the plain row pass
    standing in. Returns the times by path."""
    from tcvom_tpu_torch.infer.predict import TRIMAP_DILATION
    from tcvom_tpu_torch.models.full_model import (TaskConfig, draw_radius,
                                                   preprocess)

    res = {}
    for b, s, h, w, seed, path, dil in (
            (1, 5, 512, 512, 5, "train", None),
            (6, 3, 544, 960, 6, "val", None),
            (1, 3, 544, 960, 7, "val_ddp", None),
            (1, 3, H, W, 8, "pred_vmn", TRIMAP_DILATION["medium"])):
        cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW,
                         dilate_radius=dil)
        clip = make_clip(b, s, h, w, seed)
        seen = []

        def record(g2, t):
            seen.append((g2.clone(), t))
            return edt_kernel.edt_row_pass_ref(g2, t)

        with mock.patch.object(edt_kernel, "edt_row_pass", record):
            preprocess(clip["a"], clip["fg"], clip["bg"], cfg,
                       draw_radius(b, torch.Generator().manual_seed(3)))
        if len(seen) != 1:
            fail(f"preprocess at {[b, s, h, w]} ran {len(seen)} row passes")
        res[path] = hold_edt(edt_kernel, *seen[0], timed=path != "val",
                             path=path)
        del clip, seen
    return res


def fam_counts(mask, c, window, logits=False):
    """Bytes (q, k, mask in; out, and the logits with ``logits``) and
    operations (a multiply-add for the dot and one for the sum, per channel
    of each in-frame neighbour of each pixel inside the mask: outside it
    the outputs are 0 whatever q and k)."""
    b, h, w, _ = mask.shape
    r = window // 2
    ny = torch.tensor([min(y + r, h - 1) - max(y - r, 0) + 1
                       for y in range(h)], dtype=torch.float64)
    nx = torch.tensor([min(x + r, w - 1) - max(x - r, 0) + 1
                       for x in range(w)], dtype=torch.float64)
    inside = (mask[..., 0] != 0).double().cpu()
    nbytes = (3 * b * h * w * c + b * h * w
              + (b * h * w * window * window if logits else 0)
              ) * mask.element_size()
    return nbytes, 4.0 * c * (inside * torch.outer(ny, nx)).sum().item()


def hold_fam(fam, fam_kernel, rng, shape, window, dtype):
    """Both FAM entries against the plain version on inputs drawn from
    ``rng`` at ``shape``: out of each, and the logits; f32 to 1e-5 (rtol
    0), bf16 to 2e-2. Returns q, k, mask and the largest errors."""
    b, h, w, c = shape
    q, k = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(2))
    m = torch.from_numpy((rng.rand(b, h, w, 1) > 0.4).astype(np.float32))
    q, k, m = (t.to("cuda", dtype) for t in (q, k, m))
    got = {"fam_window": (fam_kernel.fam_window(q, k, m, window),),
           "fam_window_logits": fam_kernel.fam_window_logits(q, k, m,
                                                             window)}
    torch.cuda.synchronize()
    want = fam.fam_attention_ref(q, k, m, window)
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 2e-2)
    errs = {}
    for name, outs in got.items():
        for what, g, wt in zip(("out", "logits"), outs, want):
            err = (g.float() - wt.float()).abs()
            bad = (err > atol + rtol * wt.float().abs()).sum().item()
            errs[f"{name} {what}"] = err.max().item()
            if bad:
                fail(f"{name} {shape} {dtype} {what}: {bad} elements off")
    emit(phase="check", kernel="fam_window, fam_window_logits",
         shape=list(shape), window=window, dtype=str(dtype), atol=atol,
         rtol=rtol, max_abs_err=errs)
    return (q, k, m), errs


def check_fam(fam, fam_kernel):
    """Kernel B (``fam_window``) at the main path's [prev; next] batch in
    f32 and bf16, timed, and at a narrow shape; the logits entry is held
    at the same inputs."""
    rng = np.random.RandomState(2)
    results = {}
    for shape, window, dtype in (((2, 136, 240, 256), WINDOW, torch.float32),
                                 ((2, 136, 240, 256), WINDOW, torch.bfloat16),
                                 ((2, 16, 24, 32), 3, torch.float32),
                                 ((2, 16, 24, 32), 3, torch.bfloat16)):
        (q, k, m), errs = hold_fam(fam, fam_kernel, rng, shape, window, dtype)
        if shape[1] != 136:
            continue
        ms = time_ms(lambda: fam_kernel.fam_window(q, k, m, window), 20)
        plain_ms = time_ms(lambda: fam.fam_attention_ref(q, k, m, window), 3)
        b_ms, b_by = bound(*fam_counts(m, shape[3], window), dtype)
        results[dtype] = dict(shape=list(shape), dtype=str(dtype),
                              max_abs_err=errs["fam_window out"], ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit(phase="time", kernel="fam_window", **results[dtype])
    return results


# GroupNorm's timed shapes, bf16, with bn3's epilogue (ReLU after the
# residual add): FBA's layer4 bn3 and its stem at batch 1, layer3's bn3 at
# batch 4
GN_SHAPES = ((1, 2048, 136, 240), (1, 64, 544, 960), (4, 1024, 136, 240))
# the main path's other epilogues, held alike but not timed: LeakyReLU in
# the PPM (its 6x6 and 1x1 grids) and conv_up3, none in layer2's downsample
GN_EPILOGUES = (((1, 256, 6, 6), "leaky_relu"), ((1, 256, 1, 1), "leaky_relu"),
                ((1, 256, 544, 960), "leaky_relu"), ((1, 512, 136, 240), None))


def check_group_norm(group_norm_kernel):
    """Kernel E (``group_norm_stats`` and ``group_norm_apply``) in bf16,
    with bn3's epilogue at GN_SHAPES and the others at GN_EPILOGUES,
    against the plain composition in f32 of the same bf16 inputs: within
    2^-7 (1 + |value|), two bf16 ulps at 1. At GN_SHAPES timed by CUDA
    events beside the bytes bound of the function (x and the residual
    read, y written), each kernel apart by the profiler beside its own
    (statistics: x read; apply: x and the residual read, y written), the
    plain composition in bf16 and PyTorch's F.group_norm alone (library)."""
    import torch.nn.functional as F

    gk = group_norm_kernel
    results = {}
    for shape, act, residual in ([(s, "relu", True) for s in GN_SHAPES]
                                 + [(s, a, False) for s, a in GN_EPILOGUES]):
        g = torch.Generator(device="cuda").manual_seed(11)
        x, r = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        r = r if residual else None
        w = (torch.rand(shape[1], generator=g, device="cuda")
             + 0.5).bfloat16()
        b = torch.randn(shape[1], generator=g, device="cuda").bfloat16()

        def kernel():
            return gk.group_norm_cuda(x, 32, w, b, 1e-5, act, r)

        got = kernel().float()
        want = gk.group_norm_ref(x.float(), 32, w.float(), b.float(), 1e-5,
                                 act, None if r is None else r.float())
        err = (got - want).abs()
        bad = (err > 2 ** -7 * (1 + want.abs())).sum().item()
        del got, want
        emit(phase="check", kernel="group_norm", shape=list(shape),
             dtype="bfloat16", act=act, residual=residual,
             tolerance="2^-7 (1 + |value|)", max_abs_err=err.max().item())
        if bad:
            fail(f"group_norm {shape} {act}: {bad} elements off")
        if shape not in GN_SHAPES:
            continue
        nbytes = x.numel() * x.element_size()
        ms = time_ms(kernel, 20)
        stats_ms = device_ms(kernel, 10, "group_norm_stats")
        apply_ms = device_ms(kernel, 10, "group_norm_apply")
        b_ms, b_by = bound(3 * nbytes, 8 * x.numel(), torch.bfloat16)
        results[shape] = dict(
            shape=list(shape), dtype="bfloat16", max_abs_err=err.max().item(),
            ms=ms, plain_ms=time_ms(lambda: gk.group_norm_ref(
                x, 32, w, b, 1e-5, act, r), 20),
            library_ms=time_ms(lambda: F.group_norm(x, 32, w, b, 1e-5), 20),
            bound_ms=b_ms, bound_by=b_by)
        emit(phase="time", kernel="group_norm", **results[shape],
             bound_share=b_ms / ms, stats_ms=stats_ms,
             stats_bound_share=nbytes / HBM_BYTES_PER_S * 1e3 / stats_ms,
             apply_ms=apply_ms,
             apply_bound_share=3 * nbytes / HBM_BYTES_PER_S * 1e3 / apply_ms)
        del x, r, err
    return results


# DIM's five pools at 1088x1920: (channels, H, W) of each pool's input
# (the unpool of the same level writes a tensor of that shape)
POOL_LEVELS = ((64, 1088, 1920), (128, 544, 960), (256, 272, 480),
               (512, 136, 240), (512, 68, 120))


def check_argmax_pool(argmax_pool_kernel):
    """DIM's pool and unpool kernels (``argmax_pool_fwd``,
    ``argmax_pool_unpool``) through the model's dispatch against the plain
    ops on the card, bit for bit and in the same memory layout, at
    POOL_LEVELS, batch 1 and 4, bf16 and f32, NCHW and channels-last (as
    DIM's encoder holds them), on values with every pattern of ties (half
    from {0, 1, 2}); in bf16 each kernel's device time by the profiler
    beside its bytes bound (the larger side's values read or written, the
    smaller side's values and uint8 indices): the NCHW pool and unpool,
    the channels-last pool, and the whole unpool call given a
    channels-last index (the index made contiguous first, as in DIM's
    head) by CUDA events; the plain ops' CUDA-event time, and PyTorch's
    F.max_pool2d / F.max_unpool2d (int64 flat indices: the same function
    in another index format) as the library time. Returns the bf16 rows
    by (batch, level)."""
    import torch.nn.functional as F

    from tcvom_tpu_torch.ops.image import max_pool_argmax_2x2, max_unpool_2x2

    ak = argmax_pool_kernel
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        for batch in (1, 4):
            for level, shape in enumerate(POOL_LEVELS, 1):
                g = torch.Generator(device="cuda").manual_seed(level)
                x = torch.randint(0, 3, (batch,) + shape, generator=g,
                                  device="cuda").to(dtype)
                x[batch * shape[0] // 2:] = torch.randn(
                    x[batch * shape[0] // 2:].shape, generator=g,
                    device="cuda").to(dtype)
                x_cl = x.to(memory_format=torch.channels_last)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                for inp in (x, x_cl):
                    y, idx = max_pool_argmax_2x2(inp)
                    out = max_unpool_2x2(y, idx)
                    want_y, want_idx = ak.max_pool_argmax_2x2_ref(inp)
                    want = ak.max_unpool_2x2_ref(want_y, want_idx)
                    same = (torch.equal(y.view(bits), want_y.view(bits))
                            and torch.equal(idx, want_idx)
                            and torch.equal(out.view(bits), want.view(bits))
                            and (y.stride(), idx.stride(), out.stride())
                            == (want_y.stride(), want_idx.stride(),
                                want.stride()))
                    emit(phase="check", kernel="argmax_pool",
                         shape=[batch, *shape], dtype=str(dtype),
                         channels_last=inp is x_cl, bit_identical=same)
                    if not same:
                        fail(f"argmax_pool {[batch, *shape]} {dtype}: the "
                             "kernels differ from the plain ops")
                    del want_y, want_idx, want
                y_cl, idx_cl = max_pool_argmax_2x2(x_cl)
                y, idx = max_pool_argmax_2x2(x)
                if dtype != torch.bfloat16:
                    continue
                n, size = x.numel(), x.element_size()
                nbytes = n * size + n // 4 * (size + 1)
                pool_ms = device_ms(lambda: max_pool_argmax_2x2(x), 10,
                                    "argmax_pool_fwd")
                unpool_ms = device_ms(lambda: max_unpool_2x2(y, idx), 10,
                                      "argmax_pool_unpool")
                b_ms, b_by = bound(nbytes, 0, dtype)
                flat = F.max_pool2d(x, 2, 2, return_indices=True)[1]
                res[(batch, level)] = row = dict(
                    shape=[batch, *shape], dtype="bfloat16",
                    pool_ms=pool_ms, unpool_ms=unpool_ms, bound_ms=b_ms,
                    bound_by=b_by,
                    plain_pool_ms=time_ms(
                        lambda: ak.max_pool_argmax_2x2_ref(x), 10),
                    plain_unpool_ms=time_ms(
                        lambda: ak.max_unpool_2x2_ref(y, idx), 10),
                    library_pool_ms=time_ms(lambda: F.max_pool2d(
                        x, 2, 2, return_indices=True), 10),
                    library_unpool_ms=time_ms(lambda: F.max_unpool2d(
                        y, flat, 2, 2, output_size=shape[1:]), 10),
                    pool_channels_last_ms=device_ms(
                        lambda: max_pool_argmax_2x2(x_cl), 10,
                        "argmax_pool_fwd"),
                    unpool_channels_last_index_call_ms=time_ms(
                        lambda: max_unpool_2x2(y, idx_cl), 10))
                emit(phase="time", kernel="argmax_pool", **row,
                     pool_bound_share=b_ms / pool_ms,
                     unpool_bound_share=b_ms / unpool_ms)
                del x, y, idx, out, flat, x_cl, y_cl, idx_cl
    torch.cuda.empty_cache()
    return res


def check_fam_logits(fam, fam_kernel):
    """The logits-writing entry (replacing TPU kernels C and D) at the
    training step's [prev; next] batch (B*(S-2)*2 = 6 at 64x64), the
    validation step's (12 at 68x120; 2 at B = 1, the DDP validation's),
    a pred_vmn batch's (2 at 136x240),
    timed, and a narrow shape in f32 and bf16, the inference entry held at
    the same inputs; then the autograd
    Function's dq, dk against the plain version's autograd at the training
    shape, with random d_out and d_logits. Returns the times at the
    training and validation shapes, by shape."""
    rng = np.random.RandomState(4)
    res = {}
    for shape, window, dtype in (((6, 64, 64, 256), WINDOW, torch.float32),
                                 ((12, 68, 120, 256), WINDOW, torch.float32),
                                 ((2, 68, 120, 256), WINDOW, torch.float32),
                                 ((2, 136, 240, 256), WINDOW, torch.float32),
                                 ((2, 16, 24, 32), 3, torch.float32),
                                 ((2, 16, 24, 32), 3, torch.bfloat16)):
        (q, k, m), errs = hold_fam(fam, fam_kernel, rng, shape, window, dtype)
        b, h, w, c = shape
        if h < 64:
            continue
        ms = time_ms(lambda: fam_kernel.fam_window_logits(q, k, m, window),
                     20)
        plain_ms = time_ms(lambda: fam.fam_attention_ref(q, k, m, window), 3)
        b_ms, b_by = bound(*fam_counts(m, c, window, logits=True), dtype)
        res[shape] = dict(shape=list(shape), dtype=str(dtype),
                          max_abs_err=max(errs["fam_window_logits out"],
                                          errs["fam_window_logits logits"]),
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
        emit(phase="time", kernel="fam_window_logits", **res[shape])
        if b == 6:
            grads = []
            d_out, d_lg = (torch.from_numpy(rng.randn(*s).astype(
                np.float32)).cuda() for s in (q.shape, q.shape[:3]
                                              + (window * window,)))
            for f in (fam.FamAttention.apply, fam.fam_attention_ref):
                q_, k_ = (t.clone().requires_grad_() for t in (q, k))
                out, lg = f(q_, k_, m, window)
                grads.append(torch.autograd.grad((out, lg), (q_, k_),
                                                 (d_out, d_lg)))
            err = max((g - wt).abs().max().item()
                      for g, wt in zip(*grads))
            emit(phase="check", kernel="fam_window_logits", what="dq, dk",
                 shape=list(shape), atol=1e-5, max_abs_err=err)
            if err > 1e-5:
                fail(f"FamAttention gradients off by {err}")
    return res


def check_fam_width(fam, fam_kernel, c: int, seed: int):
    """Kernel B (``fam_window``) in f32 and bf16 and the logits entry
    (kernels C/D) in f32 at a backbone's [prev; next] batch, [2, 136, 240,
    c], window 7, each held against the plain version and timed: ``ms``
    is the profiler's device time (at C = 32 a launch runs shorter than
    the wrapper's call takes; the CUDA-event time beside it, ``event_ms``,
    is the launch rate). Returns the times by dtype, and the logits
    entry's under "logits"."""
    rng = np.random.RandomState(seed)
    shape, res = (2, H // 8, W // 8, c), {}
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, m), errs = hold_fam(fam, fam_kernel, rng, shape, WINDOW,
                                   dtype)
        entries = [(dtype, "fam_window", False)]
        if dtype == torch.float32:
            entries.append(("logits", "fam_window_logits", True))
        for key, name, logits in entries:
            fn = getattr(fam_kernel, name)
            event_ms = time_ms(lambda: fn(q, k, m, WINDOW), 20)
            ms = device_ms(lambda: fn(q, k, m, WINDOW), 20,
                           "fam_window_mma_kernel")
            plain_ms = time_ms(lambda: fam.fam_attention_ref(q, k, m, WINDOW),
                               3)
            b_ms, b_by = bound(*fam_counts(m, c, WINDOW, logits=logits),
                               dtype)
            err = max(v for e, v in errs.items() if e.startswith(name + " "))
            res[key] = dict(shape=list(shape), dtype=str(dtype),
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
            emit(phase="time", kernel=name, **res[key], event_ms=event_ms)
    return res


def make_clip(b: int, s: int, h: int, w: int, seed: int) -> dict:
    """A synthetic training batch shaped like the dataset's crops, on the
    card: per sample a soft-edged disc moving across the clip (alpha 0 and
    255 with a 12-pixel ramp between, so the unknown region is never
    empty), noise foreground and background; f32, 0..255."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    a = np.zeros((b, s, h, w, 1), np.float32)
    for i in range(b):
        cy, cx = rng.uniform(0.35, 0.65, 2) * (h, w)
        vy, vx = rng.uniform(-8, 8, 2)
        r = rng.uniform(0.15, 0.3) * min(h, w)
        for t in range(s):
            d = np.hypot(yy - cy - vy * t, xx - cx - vx * t)
            a[i, t, ..., 0] = np.clip((r - d) / 12.0, 0.0, 1.0) * 255.0
    fg, bg = ((rng.rand(b, s, h, w, 3) * 255).astype(np.float32)
              for _ in range(2))
    return {k: torch.from_numpy(v).cuda() for k, v in
            (("a", a), ("fg", fg), ("bg", bg))}


def pred_test_phase(model, tmp, step_ms, fam, edt_kernel, cuda_build):
    """The wild-folder pipeline (tools/pred_test.py's predict_test_folder) in
    bf16 on 8 frames of 1080x1920 PNGs written by the port's own writer:
    through the kernels (launches counted), through the plain versions
    (the mattes held within BF16_STREAM), and through the kernels again,
    timed end to end beside the stream's own step rate, once with each PNG
    codec this machine has (cv2 if it imports, the port's zlib codec
    always). Returns the counted run's launches."""
    from tcvom_tpu_torch.infer.predict import predict_test_folder
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.tools.make_fake_dataset import make_wild_folder
    from tcvom_tpu_torch.utils import imageio

    n, hw = 8, FRAME_HW
    src = str(tmp / "wild")
    make_wild_folder(src, frames=n, hw=hw, seed=7)
    cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW)

    def run(out):
        t0 = time.perf_counter()
        stats = predict_test_folder(model, cfg, src, str(tmp / out),
                                    dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mattes = [imageio.imread(str(tmp / out / f"{i:05d}_alpha.png"),
                                 imageio.IMREAD_GRAYSCALE) for i in range(n)]
        return stats, wall, mattes

    cuda_build.LAUNCHES.clear()
    _, first_wall, got = run("kernels")
    counts = dict(cuda_build.LAUNCHES)
    if counts != with_norms({"edt_row": n, "fam_window": n}, n * FBA_NORMS):
        fail(f"pred_test launch counts {counts}, want {n} of each and "
             f"{FBA_NORMS} a frame of each GroupNorm kernel")
    for i, matte in enumerate(got):
        tri = imageio.imread(f"{src}/{i:05d}_trimap.png",
                             imageio.IMREAD_GRAYSCALE)
        known = (tri == 0) | (tri == 255)
        if matte.shape != hw or matte.dtype != np.uint8:
            fail(f"pred_test matte {matte.shape} {matte.dtype}")
        if not np.array_equal(matte[known], tri[known]):
            fail(f"pred_test matte {i}: known pixels differ from the trimap")
    # the GroupNorm kernels in both runs, as in the bf16 stream's hold
    with plain_kernels(fam, edt_kernel, group_norm=False):
        cuda_build.LAUNCHES.clear()
        _, _, want = run("plain")
        if dict(cuda_build.LAUNCHES) != with_norms({}, n * FBA_NORMS):
            fail(f"a plain run launched kernels: {dict(cuda_build.LAUNCHES)}")
    diff, same = hold_stream("pred_test", [torch.from_numpy(m) for m in want],
                             [torch.from_numpy(m) for m in got])
    if diff > BF16_STREAM["max_level_diff"] or \
            same < BF16_STREAM["identical_share"]:
        fail(f"pred_test mattes: kernels {diff} levels off plain at most, "
             f"{same:.6f} identical; allowed {BF16_STREAM}")
    for codec in ("cv2", "zlib") if imageio.cv2 else ("zlib",):
        with mock.patch.object(imageio, "cv2",
                               imageio.cv2 if codec == "cv2" else None):
            stats, wall, _ = run(f"timed_{codec}")
        emit(phase="pred_test", frames=n, shape=list(hw), codec=codec,
             launches=counts, first_run_s=first_wall, wall_s=wall,
             fps_end_to_end=n / wall, fps_step=1e3 / step_ms,
             ms_per_frame={k: v * 1e3 / n for k, v in stats.items()
                           if k != "frames"})
    return counts


def pred_vmn_phase(model, tmp, cuda_build, profile_path=None):
    """The VideoMatting108 validation sweep (tools/pred_vmn.py) on a fake
    tree, one val clip of 4 frames at 1080x1920, from a checkpoint of
    ``model``'s weights: f32, B = 1, S = 3, 1088x1920, medium trimaps; then
    its parts apart: reading one sample, and the evaluation step on it
    (and a profile of one step with ``profile_path``). Returns (launches,
    the tree, the predictions' folder, the sweep's seconds by phase with
    its peak device memory under ``peak_gib``)."""
    from tcvom_tpu_torch.data.vmd import VideoMattingDataset
    from tcvom_tpu_torch.infer.predict import (TRIMAP_DILATION,
                                               make_vmd_eval_step)
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.tools import pred_vmn
    from tcvom_tpu_torch.tools.make_fake_dataset import make
    from tcvom_tpu_torch.utils.checkpoint import save_weights

    root, save, ckpt = tmp / "vmd", tmp / "pred_vmn", tmp / "vmn_fba.pth"
    t0 = time.perf_counter()
    make(str(root), frames=4, hw=FRAME_HW, seed=0)
    save_weights(model, str(ckpt))
    setup_s = time.perf_counter() - t0
    cuda_build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0, sweep = time.perf_counter(), {}
    losses = pred_vmn.main(["--model", "fba", "--data", str(root), "--load",
                            str(ckpt), "--trimap", "medium", "--save",
                            str(save), "--agg_window", str(WINDOW),
                            "--batch", "1", "--n_threads", "2"], sweep)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(cuda_build.LAUNCHES)
    written = sorted(p.name for p in (save / "clip_b").iterdir())

    dataset = VideoMattingDataset(str(root), (H, W), "val",
                                  precomputed_val=str(root), sample_length=3,
                                  no_flow=True)
    t0 = time.perf_counter()
    sample = {k: v[None] for k, v in dataset[(0, 1)].items()}
    read_ms = (time.perf_counter() - t0) * 1e3
    step = make_vmd_eval_step(model, TaskConfig(
        model="vmn_fba", agg_window=WINDOW,
        dilate_radius=TRIMAP_DILATION["medium"]))
    step_ms = host_ms(lambda: step(sample), 3)
    emit(phase="pred_vmn", samples=4, shape=[1, 3, H, W], launches=counts,
         losses=losses, setup_s=setup_s, sweep_s=sweep_s,
         s_per_sample=sweep_s / 4, sweep_phases_s=sweep,
         written=len(written), sample_read_ms=read_ms, eval_step_ms=step_ms)
    if profile_path:
        profile_steps(lambda: step(sample), 1, profile_path,
                      "profile_pred_vmn")
    if counts != with_norms({"edt_row": 4, "fam_window_logits": 4},
                            4 * FBA_NORMS):
        fail(f"pred_vmn launch counts {counts}, want 4 of each and "
             f"{FBA_NORMS} a sample of each GroupNorm kernel")
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"pred_vmn losses {losses}")
    if written != [f"{i:05d}_{k}.png" for i in range(4)
                   for k in ("pred", "tri")]:
        fail(f"pred_vmn wrote {written}")
    return counts, root, save, sweep


def calc_metric_phase(root, save):
    """tools/calc_metric.py on pred_vmn's output, on the card and on the
    CPU: every number of metric.json within rtol 1e-5; then on the card
    with --vis: one captioned error image a frame, (1080 + 100) x 3840,
    and metric.json as without the flag."""
    from tcvom_tpu_torch.tools import calc_metric
    from tcvom_tpu_torch.utils import imageio

    res, secs = {}, {}
    for dev, vis in (("cuda", []), ("cpu", []), ("cuda_vis", ["--vis"])):
        t0 = time.perf_counter()
        res[dev] = calc_metric.main(["--pred", str(save), "--data", str(root),
                                     "--device", dev.split("_")[0],
                                     "--output",
                                     str(save / f"metric_{dev}.json")] + vis)
        secs[dev] = time.perf_counter() - t0
    vis_shapes = [imageio.imread(str(p)).shape
                  for p in sorted((save / "vis" / "clip_b").iterdir())]
    if res.pop("cuda_vis") != res["cuda"]:
        fail("calc_metric --vis changed metric.json")
    if vis_shapes != [(FRAME_HW[0] + 100, 2 * FRAME_HW[1], 3)] * 4:
        fail(f"calc_metric --vis wrote {vis_shapes}")
    worst = 0.0

    def walk(a, b):
        nonlocal worst
        if isinstance(a, dict):
            if set(a) != set(b):
                fail(f"calc_metric keys differ: {set(a) ^ set(b)}")
            for k in a:
                walk(a[k], b[k])
        else:
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))

    walk(res["cuda"], res["cpu"])
    pairs = len(res["cuda"]["all"]["clip_b"]["all"])
    emit(phase="calc_metric", pairs=pairs, avg=res["cuda"]["avg"],
         s_per_pair={d: t / pairs for d, t in secs.items()},
         max_rel_diff_cuda_cpu=worst, vis=vis_shapes)
    if pairs != 4 or worst > 1e-5:
        fail(f"calc_metric: {pairs} pairs, card vs CPU rel diff {worst}")
    if not all(np.isfinite(v) for v in res["cuda"]["avg"].values()):
        fail(f"calc_metric values {res['cuda']['avg']}")


def train_phase(fam, edt_kernel, cuda_build, profile_path=None):
    """The video trainer at full width and depth: a kernel step against a
    plain step from the same weights, batch and radius; five more kernel
    steps (and a profile of two with ``profile_path``); one validation
    step. Returns the launches of the kernel step and of the validation
    step."""
    from tcvom_tpu_torch.models.full_model import TaskConfig, draw_radius
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW)
    trainer = MattingTrainer(cfg, "vmd", optimizer="adam", lr_strategy="poly",
                             base_lr=1e-4, weight_decay=1e-4, total_iters=30)
    batch = make_clip(1, 5, 512, 512, seed=5)
    radius = draw_radius(1, torch.Generator().manual_seed(3))

    def plain_step(state, batch):
        with plain_kernels(fam, edt_kernel):
            _, metrics = trainer.train_step(state, batch, radius)
        torch.cuda.synchronize()
        return metrics

    def grads(state):
        return {n: p.grad.double() for n, p in
                state.model.named_parameters()}

    plain = trainer.init_state(torch.Generator().manual_seed(0))
    cuda_build.LAUNCHES.clear()
    m_plain = plain_step(plain, batch)
    if sum(cuda_build.LAUNCHES.values()):
        fail(f"the plain step launched kernels: {dict(cuda_build.LAUNCHES)}")
    g_plain = grads(plain)
    del plain

    state = trainer.init_state(torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    t0 = time.perf_counter()
    state, m_kern = trainer.train_step(state, batch, radius)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(cuda_build.LAUNCHES)
    if counts != {"edt_row": 1, "fam_window_logits": 1}:
        fail(f"train step launch counts {counts}, want one edt_row and one "
             "fam_window_logits")
    loss_rel = {k: abs(m_kern[k].item() - m_plain[k].item())
                / abs(m_plain[k].item()) for k in m_plain if k != "lr"}
    g_kern = grads(state)
    # relative L2 error of each gradient within 1e-4
    rows = [(n, (g_kern[n] - gp).norm().item() / gp.norm().item())
            for n, gp in g_plain.items()]
    bad = [r for r in rows if r[1] > 1e-4]
    worst = sorted(rows, key=lambda r: -r[1])[:5]
    emit(phase="train_f32", what="kernels vs plain", launches=counts,
         losses={k: m_kern[k].item() for k in loss_rel},
         loss_rel_err=loss_rel,
         grad_rel_err_worst=[list(r) for r in worst],
         grad_rel_err_median=float(np.median([r[1] for r in rows])),
         params=len(rows),
         first_step_ms=first_ms)
    if max(loss_rel.values()) > 1e-4:
        fail(f"kernel and plain step losses differ: {loss_rel}")
    if bad:
        fail(f"kernel and plain step gradients differ: {bad[:5]}")

    step_ms, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    if not all(np.isfinite(losses)):
        fail(f"train losses not finite: {losses}")
    emit(phase="train_f32", what="steps", shape=[1, 5, 512, 512],
         step_ms=step_ms, losses=losses, lr=metrics["lr"],
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    if profile_path:
        profile_steps(lambda: trainer.train_step(state, batch), 2,
                      profile_path, "profile_train_f32")

    val = make_clip(6, 3, 544, 960, seed=6)
    cuda_build.LAUNCHES.clear()
    t0 = time.perf_counter()
    value, (alpha_c, _, _) = trainer.val_dt_step(state, val)
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    val_counts = dict(cuda_build.LAUNCHES)
    emit(phase="val_dt", shape=[6, 3, 544, 960], value=value.item(),
         launches=val_counts, ms=val_ms)
    if val_counts != with_norms({"edt_row": 1, "fam_window_logits": 1},
                                FBA_NORMS):
        fail(f"validation launch counts {val_counts}")
    if not np.isfinite(value.item()) or alpha_c.shape != (6, 544, 960, 1):
        fail(f"validation value {value.item()}, alpha {tuple(alpha_c.shape)}")
    return counts, val_counts


TRAIN_SHAPES = ((24, 64, 64, 256), (24, 64, 64, 32), (36, 64, 64, 128),
                (12, 68, 120, 32), (12, 68, 120, 128))


def check_fam_train_widths(fam, fam_kernel):
    """The logits entry (kernels C/D) at the other backbones' training and
    validation batches: both neighbours of B*(S-2) centres at OS 8 of
    512x512 (DIM and IndexNet B = 4, GCA B = 6, S = 5) and of 544x960 (B =
    6, S = 3) at their widths, f32, window 7: held against the plain
    version (out and logits, and the autograd Function's dq, dk), timed
    by the profiler's device time (CUDA events beside). Returns the times
    by shape."""
    rng = np.random.RandomState(11)
    res = {}
    for shape in TRAIN_SHAPES:
        (q, k, m), errs = hold_fam(fam, fam_kernel, rng, shape, WINDOW,
                                   torch.float32)
        c = shape[3]
        grads = []
        d_out, d_lg = (torch.from_numpy(rng.randn(*s).astype(
            np.float32)).cuda() for s in (q.shape, q.shape[:3]
                                          + (WINDOW * WINDOW,)))
        for f in (fam.FamAttention.apply, fam.fam_attention_ref):
            q_, k_ = (t.clone().requires_grad_() for t in (q, k))
            out, lg = f(q_, k_, m, WINDOW)
            grads.append(torch.autograd.grad((out, lg), (q_, k_),
                                             (d_out, d_lg)))
        g_err = max((g - wt).abs().max().item() for g, wt in zip(*grads))
        if g_err > 1e-5:
            fail(f"FamAttention gradients at {shape} off by {g_err}")

        def call():
            return fam_kernel.fam_window_logits(q, k, m, WINDOW)

        event_ms = time_ms(call, 20)
        ms = device_ms(call, 20, "fam_window_mma_kernel")
        plain_ms = time_ms(lambda: fam.fam_attention_ref(q, k, m, WINDOW), 3)
        b_ms, b_by = bound(*fam_counts(m, c, WINDOW, logits=True),
                           torch.float32)
        res[shape] = dict(shape=list(shape), dtype=str(torch.float32),
                          max_abs_err=max(errs["fam_window_logits out"],
                                          errs["fam_window_logits logits"]),
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
        emit(phase="time", kernel="fam_window_logits", **res[shape],
             event_ms=event_ms, dq_dk_max_abs_err=g_err)
    return res


def train_buffers(model) -> dict:
    """The state a train step updates besides the parameters: every
    BatchNorm's running statistics and every spectral-norm u and v."""
    return {n: b.detach().double().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var", "weight_u",
                           "weight_v"))}


# The FAM output's relative perturbation of a train step's rounding floor:
# the f32 kernel's outputs lie ~1.5e-6 from the plain version's at unit
# scale (phase "check" at the training shapes)
FAM_ROUNDING = 1e-6
# The ceiling of a train phase's gradient limit. On an H100 the kernel
# step's largest module error was 3.0e-4 (DIM) and 1.3e-3 (IndexNet), the
# perturbed step's 1.3e-3 and 1.8e-3; either step past it fails the phase
GRAD_LIMIT_CAP = 1e-2


def perturbed_fam(fam, seed: int):
    """A context in which the plain FAM stands in for the kernel with its
    output and logits perturbed by ``FAM_ROUNDING`` relative Gaussian
    noise (fixed by ``seed``): a difference of the kernel's size, whatever
    its source."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jitter(t):
        return t * (1.0 + FAM_ROUNDING * torch.randn(
            t.shape, generator=gen, device=t.device, dtype=t.dtype))

    def noisy_fam(q, k, mask, window, need_logits=False):
        out, lg = fam.fam_attention_ref(q, k, mask, window)
        return jitter(out), (jitter(lg) if need_logits else None)

    return mock.patch.object(fam, "fam_attention", noisy_fam)


def module_grad_errors(got: dict, want: dict) -> list:
    """(relative L2 error, module) of each module's gradient, its
    parameters' gradients taken as one vector, worst first. A parameter's
    own relative error is no measure where its exact gradient is 0: a conv
    bias right before a BatchNorm in training mode (the normalization
    takes the per-channel mean out), and in the same way a bias whose
    per-channel constant a later training-mode BatchNorm removes; its
    gradient is rounding, and two plain steps differ by O(1) there."""
    mods = {}
    for n in want:
        mods.setdefault(n.rsplit(".", 1)[0], []).append(n)
    rows = []
    for m, names in mods.items():
        g = torch.cat([got[n].flatten() for n in names])
        w = torch.cat([want[n].flatten() for n in names])
        scale = w.norm().item()
        rows.append(((g - w).norm().item() / scale if scale
                     else (g - w).norm().item(), m))
    return sorted(rows, reverse=True)


def train_setup(name: str):
    """The ``train_<name>_f32`` phases' set-up of ``vmn_<name>`` at its
    cfgs/vmd_vmn_<name>_pretrained_30ep.yaml's per-card batch (S = 5,
    512x512): (task, trainer arguments, batch, radius, seed-0 weights;
    GCA's u and v converged, DIM calibrated on the batch)."""
    from tcvom_tpu_torch.config import load_config
    from tcvom_tpu_torch.models import full_model as FM
    from tcvom_tpu_torch.models.registry import (calibrate_random_weights,
                                                 converge_spectral_norms)
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    tcfg = load_config(str(ROOT / "cfgs" /
                           f"vmd_vmn_{name}_pretrained_30ep.yaml")).TRAIN
    b = tcfg.BATCH_SIZE_PER_GPU
    h, w = tcfg.TRAIN_INPUT_SIZE
    task = FM.TaskConfig(model=f"vmn_{name}", agg_window=WINDOW)
    kw = dict(optimizer=tcfg.OPTIMIZER, lr_strategy=tcfg.LR_STRATEGY,
              base_lr=tcfg.BASE_LR, weight_decay=tcfg.WEIGHT_DECAY,
              total_iters=30)
    batch = make_clip(b, 5, h, w, seed=5)
    radius = FM.draw_radius(b, torch.Generator().manual_seed(3))
    state = MattingTrainer(task, "vmd", **kw).init_state(
        torch.Generator().manual_seed(0))
    if name == "gca":
        converge_spectral_norms(state.model)
    if name == "dim":
        calibrate_random_weights(state.model, lambda: FM.forward_vmd(
            state.model, batch, task, radius))
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    return task, kw, batch, radius, weights


def fresh_state(trainer, weights, like=None):
    """A state of ``trainer`` holding ``weights``, or with ``like`` a copy
    of that state: weights, statistics, Adam's moments, step and
    generators."""
    st = trainer.init_state(torch.Generator().manual_seed(0))
    st.model.load_state_dict(like.model.state_dict() if like else weights)
    if like is not None:
        st.optimizer.load_state_dict(like.optimizer.state_dict())
        st.step = like.step
        st.generator.set_state(like.generator.get_state())
        if like.dropout_generator is not None:
            st.dropout_generator.set_state(like.dropout_generator.get_state())
    return st


def train_backbone_phase(name: str, fam, edt_kernel, cuda_build,
                         profile_path=None):
    """The video trainer of ``vmn_<name>`` (DIM, IndexNet or GCA) at full
    published width, as cfgs/vmd_vmn_<name>_pretrained_30ep.yaml sets it
    (Adam, poly lr, weight decay, its per-card batch; S = 5 at its
    512x512 crops), random weights from seed 0 (GCA's u and v converged,
    DIM calibrated on the batch). From the same weights, batch, radius and
    dropout seed, with PyTorch's deterministic algorithms: a plain step, a
    plain step with the FAM output perturbed at the kernel's rounding
    (``perturbed_fam``) and a kernel step. The kernel step's losses within
    rtol 1e-4 of the plain step's; its BatchNorm statistics, u and v
    within 1e-5; each module's gradient within relative L2 1e-4 of the
    plain step's, or, where the perturbed step moves some module further
    than that, within twice the perturbed step's largest error (DIM's and
    IndexNet's L1 losses flip sign at residuals within rounding of 0, and
    each flip moves every gradient), and never past ``GRAD_LIMIT_CAP``,
    which the perturbed step's own error must not pass either. Then three
    more kernel steps (and a profile of two with ``profile_path``) and one
    validation step (B = 6, S = 3, 544x960). Returns the launches of the
    kernel step and of the validation step."""
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    task, kw, batch, radius, weights = train_setup(name)
    b, _, h, w = batch["a"].shape[:4]
    trainer = MattingTrainer(task, "vmd", **kw)

    def fresh(weights):
        return fresh_state(trainer, weights)

    def held_step(ctx):
        """One step from ``weights`` in ``ctx``, deterministic: (metrics,
        gradients, buffers, launches)."""
        st = fresh(weights)
        cuda_build.LAUNCHES.clear()
        torch.use_deterministic_algorithms(True)
        try:
            with ctx:
                _, metrics = trainer.train_step(st, batch, radius)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        out = ({k: v.item() if torch.is_tensor(v) else v
                for k, v in metrics.items()},
               {n: p.grad.double() for n, p in st.model.named_parameters()},
               train_buffers(st.model), dict(cuda_build.LAUNCHES))
        del st
        torch.cuda.empty_cache()
        return out

    m_plain, g_plain, b_plain, n_plain = held_step(
        plain_kernels(fam, edt_kernel))
    _, g_noisy, _, _ = held_step(perturbed_fam(fam, seed=1))
    m_kern, g_kern, b_kern, counts = held_step(contextlib.nullcontext())
    if sum(n_plain.values()):
        fail(f"the plain {name} step launched kernels: {n_plain}")
    loss_rel = {k: abs(m_kern[k] - m_plain[k]) / max(abs(m_plain[k]), 1e-30)
                for k in m_plain if k != "lr"}
    kern_err = module_grad_errors(g_kern, g_plain)
    floor = module_grad_errors(g_noisy, g_plain)
    limit = min(GRAD_LIMIT_CAP, max(1e-4, 2 * floor[0][0]))
    tensor_err = sorted((((g_kern[n] - g_plain[n]).norm()
                          / g_plain[n].norm().clamp_min(1e-30)).item(), n)
                        for n in g_plain)[::-1]
    buf_err = sorted(((v - b_plain[n]).abs().max().item()
                      / max(1.0, b_plain[n].abs().max().item()), n)
                     for n, v in b_kern.items())[::-1]
    emit(phase=f"train_{name}_f32", what="kernels vs plain", batch=b,
         launches=counts, losses={k: m_kern[k] for k in loss_rel},
         loss_rel_err=loss_rel, modules=len(kern_err),
         module_grad_err_worst=kern_err[:5],
         module_grad_err_median=float(np.median([r[0] for r in kern_err])),
         perturbed_fam_err_worst=floor[:3],
         perturbed_fam_err_median=float(np.median([r[0] for r in floor])),
         grad_limit=limit, tensor_grad_err_worst=tensor_err[:3],
         buffers=len(buf_err), buffer_err_worst=buf_err[:3])
    if counts != {"fam_window_logits": 1}:
        fail(f"{name} train step launch counts {counts}, want one "
             "fam_window_logits")
    if max(loss_rel.values()) > 1e-4:
        fail(f"{name} kernel and plain step losses differ: {loss_rel}")
    if floor[0][0] > GRAD_LIMIT_CAP:
        fail(f"{name} plain step moves {floor[:3]} under a "
             f"{FAM_ROUNDING} FAM perturbation, over {GRAD_LIMIT_CAP}")
    if kern_err[0][0] > limit:
        fail(f"{name} kernel and plain step gradients differ: "
             f"{kern_err[:5]}, limit {limit}")
    if not buf_err or buf_err[0][0] > 1e-5:
        fail(f"{name} kernel and plain step statistics differ: "
             f"{buf_err[:5]}")
    del g_plain, g_noisy, g_kern

    state = fresh(weights)
    del weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    if not all(np.isfinite(losses)):
        fail(f"{name} train losses not finite: {losses}")
    emit(phase=f"train_{name}_f32", what="steps", shape=[b, 5, h, w],
         first_step_ms=step_ms[0], step_ms=step_ms[1:], losses=losses,
         lr=metrics["lr"],
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    if profile_path:
        profile_steps(lambda: trainer.train_step(state, batch), 2,
                      profile_path, f"profile_train_{name}_f32")
    del batch
    val = make_clip(6, 3, 544, 960, seed=6)
    cuda_build.LAUNCHES.clear()
    t0 = time.perf_counter()
    value, (alpha_c, _, _) = trainer.val_dt_step(state, val)
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    val_counts = dict(cuda_build.LAUNCHES)
    emit(phase=f"val_dt_{name}", shape=[6, 3, 544, 960], value=value.item(),
         launches=val_counts, ms=val_ms)
    if val_counts != with_pools({"fam_window_logits": 1}, name, 1, 1):
        fail(f"{name} validation launch counts {val_counts}")
    if not np.isfinite(value.item()) or alpha_c.shape != (6, 544, 960, 1):
        fail(f"{name} validation value {value.item()}, alpha "
             f"{tuple(alpha_c.shape)}")
    return counts, val_counts


def train_cli_phase(tmp):
    """``python -m tcvom_tpu_torch.tools.train`` in subprocesses, files
    under ``tmp``: cfgs/vmd_vmn_index_pretrained_30ep.yaml over a fake
    VideoMatting108 tree (2 clips x 6 frames of 1080x1920; 6 training
    samples at B = 4 are 2 steps an epoch), from a random .pth, one epoch
    with images every step; resumed from its checkpoint for a second
    epoch (the step count carries on); then cfgs/pretrain_vmn_gca.yaml
    (--driver single --dataset dim) over a fake Adobe tree, one step from
    a random .pth: the frozen backbone's weights, BatchNorm statistics and
    u, v as they were loaded, the head's statistics moved."""
    from tcvom_tpu_torch.models.registry import build_model
    from tcvom_tpu_torch.tools.make_fake_dataset import make, make_adobe

    root, adobe, logs = tmp / "vmd_train", tmp / "adobe", tmp / "train_log"
    make(str(root), frames=6, hw=FRAME_HW, seed=1)
    make_adobe(str(adobe), n=2, hw=(720, 540), seed=2)
    index_pth = random_checkpoint("vmn_index", tmp)
    gca_pth = random_checkpoint("vmn_gca", tmp)

    def run(cfg: str, *opts, flags=()):
        cmd = [sys.executable, "-m", "tcvom_tpu_torch.tools.train", "--cfg",
               str(ROOT / "cfgs" / cfg), *flags, "SYSTEM.OUTDIR", str(logs),
               *map(str, opts)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
        secs = time.perf_counter() - t0
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            fail(f"tools.train {cfg} exited {proc.returncode}")
        out = logs / (Path(cfg).stem + "_agg7")
        with open(out / "train_stats.json") as f:
            stats = json.load(f)
        emit(phase="train_cli", cfg=cfg, seconds=secs, **stats)
        return out, proc

    out, _ = run("vmd_vmn_index_pretrained_30ep.yaml", "DATASET.PATH", root,
                 "TRAIN.LOAD_CKPT", index_pth, "TRAIN.TOTAL_STEPS", 1,
                 "TRAIN.IMAGE_FREQ", 1)
    step1 = torch.load(out / "checkpoint_1.pth", map_location="cpu")["step"]
    images = len(list((out / "training_images").iterdir()))
    out, proc = run("vmd_vmn_index_pretrained_30ep.yaml", "DATASET.PATH",
                    root, "TRAIN.LOAD_CKPT", index_pth, "TRAIN.LOAD_OPT",
                    out / "checkpoint_1.pth", "TRAIN.TOTAL_STEPS", 2,
                    "TRAIN.IMAGE_FREQ", 1)
    step2 = torch.load(out / "checkpoint_2.pth", map_location="cpu")["step"]
    if (step1, step2, images) != (2, 4, 2 * 7) or \
            "resumed full train state" not in proc.stderr:
        fail(f"train_cli index: steps {step1}, {step2}, {images} images")

    out, _ = run("pretrain_vmn_gca.yaml", "DATASET.PATH", adobe,
                 "TRAIN.LOAD_CKPT", gca_pth, "TRAIN.TOTAL_STEPS", 1,
                 flags=("--driver", "single", "--dataset", "dim"))
    loaded = torch.load(gca_pth, map_location="cpu")
    trained = torch.load(out / "checkpoint_1.pth", map_location="cpu")
    model = build_model("vmn_gca", agg_window=WINDOW, device="cpu")
    part_of = {id(m) for part in model.frozen_modules()
               for m in part.modules()}
    frozen = {f"{mn}.{n}" for mn, m in model.named_modules()
              if id(m) in part_of
              for n, _ in itertools.chain(m.named_parameters(recurse=False),
                                          m.named_buffers(recurse=False))}
    moved = sorted(k for k in frozen
                   if not torch.equal(loaded[k], trained["model"][k]))
    head = [k for k in loaded if k.startswith("decoder.layer3.")
            and k.endswith("running_var")]
    head_moved = [k for k in head
                  if not torch.equal(loaded[k], trained["model"][k])]
    emit(phase="train_cli", what="frozen backbone", step=trained["step"],
         frozen_tensors=len(frozen),
         frozen_moved=moved[:5], head_stats_moved=len(head_moved))
    if moved or not head_moved or trained["step"] != 1:
        fail(f"pretrain_vmn_gca: frozen tensors moved {moved[:5]}, "
             f"{len(head_moved)} head statistics moved")


# -- the bf16 training recipe and --remat ------------------------------------

# JAX's own bf16 training guard (tools/validate_bf16_train.py GATES, which
# the TPU run passed): the bf16 step's loss against the f32 step's at the
# same state, and the bf16 trajectory's losses against the f32
# trajectory's. Its update-cosine gate (0.90) is reported, not held: JAX's
# guard fails it at 0.74 on a TPU v5 lite (BF16_TRAIN_GUARD.json).
BF16_GATES = {"max_loss_rel_step0": 2e-2, "max_traj_ratio_dev": 0.25}
BF16_STEPS = 5


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().flatten() for t in tensors])


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Summed in f64: an f32 sum over 10^7 terms strays by ~1 %."""
    a, b = a.double(), b.double()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


@contextlib.contextmanager
def logits_dtypes(fam_kernel):
    """Records the q dtype of every launch of the logits kernel (the
    recording wrapper calls the kernel, whose wrapper counts the
    launch)."""
    seen = []
    real = fam_kernel.fam_window_logits

    def recording(q, *a, **kw):
        seen.append(str(q.dtype).removeprefix("torch."))
        return real(q, *a, **kw)

    with mock.patch.object(fam_kernel, "fam_window_logits", recording):
        yield seen


def train_bf16_phase(name: str, cuda_build, fam_kernel) -> dict:
    """``TRAIN.BF16`` on ``vmn_<name>`` (``train_setup``): along the f32
    trajectory, at each of ``BF16_STEPS`` states, the bf16 step on a copy
    of the state beside the f32 step (their losses, the cosine of their
    raw gradients and of their Adam updates); then the bf16 trajectory
    from the same weights, batch and radii (its losses against the f32
    trajectory's, ms, peak memory, launches and the dtypes of what it
    keeps). Held to ``BF16_GATES``. Returns the bf16 trajectory's
    launches."""
    from tcvom_tpu_torch.models import full_model as FM
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    task, kw, batch, _, weights = train_setup(name)
    b = batch["a"].shape[0]
    gen = torch.Generator().manual_seed(4)
    radii = [FM.draw_radius(b, gen) for _ in range(BF16_STEPS)]
    t32 = MattingTrainer(task, "vmd", **kw)
    t16 = MattingTrainer(task, "vmd", compute_dtype=torch.bfloat16, **kw)

    def step(trainer, st, k):
        """(losses, gradients, update, ms, peak GiB) of one step; the
        gradients and the update on the CPU, the peak without the copy of
        the weights the update is taken from."""
        before = flat(st.model.parameters())
        held = before.numel() * before.element_size()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m = trainer.train_step(st, batch, radii[k])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        grads = flat(p.grad for p in st.model.parameters()).cpu()
        update = (flat(st.model.parameters()) - before).cpu()
        return ({k_: v.item() for k_, v in m.items() if k_ != "lr"}, grads,
                update, ms, peak)

    st32 = fresh_state(t32, weights)
    f32, rows = [], []
    for k in range(BF16_STEPS):
        fork = fresh_state(t16, weights, like=st32)
        m16, g16, u16, _, _ = step(t16, fork, k)
        del fork
        torch.cuda.empty_cache()
        m32, g32, u32, ms32, peak32 = step(t32, st32, k)
        f32.append((m32, ms32, peak32))
        rows.append(dict(loss_rel=m16["loss"] / m32["loss"] - 1.0,
                         grad_cosine=cosine(g16, g32),
                         update_cosine=cosine(u16, u32)))
        del g16, u16, g32, u32
    del st32
    torch.cuda.empty_cache()

    st16 = fresh_state(t16, weights)
    cuda_build.LAUNCHES.clear()
    traj = []
    with logits_dtypes(fam_kernel) as dtypes:
        for k in range(BF16_STEPS):
            m16, _, _, ms16, peak16 = step(t16, st16, k)
            traj.append((m16, ms16, peak16))
    counts = dict(cuda_build.LAUNCHES)
    opt_state = [t for s in st16.optimizer.state.values()
                 for k, t in s.items() if k != "step"]
    kept = {"parameters": {str(p.dtype) for p in st16.model.parameters()},
            "moments": {str(t.dtype) for t in opt_state},
            "buffers": {str(t.dtype) for t in st16.model.buffers()
                        if t.is_floating_point()}}
    del st16
    torch.cuda.empty_cache()
    ratio = [m16["loss"] / m32["loss"] for (m16, _, _), (m32, _, _)
             in zip(traj, f32)]
    logits = {f"fam_window_logits_{d}": dtypes.count(d)
              for d in ("float32", "bfloat16")}
    emit(phase=f"train_{name}_bf16", batch=b, steps=BF16_STEPS,
         loss_rel=[r["loss_rel"] for r in rows],
         grad_cosine=[r["grad_cosine"] for r in rows],
         update_cosine=[r["update_cosine"] for r in rows],
         f32_losses=[m["loss"] for m, _, _ in f32],
         bf16_losses=[m["loss"] for m, _, _ in traj], traj_ratio=ratio,
         gates=BF16_GATES, launches=counts, logits_launches=logits,
         dtypes={k: sorted(v) for k, v in kept.items()},
         f32_later_step_ms=float(np.median([ms for _, ms, _ in f32[1:]])),
         bf16_later_step_ms=float(np.median([ms for _, ms, _ in traj[1:]])),
         f32_step_ms=[ms for _, ms, _ in f32],
         bf16_step_ms=[ms for _, ms, _ in traj],
         f32_peak_gib=max(p for _, _, p in f32),
         bf16_peak_gib=max(p for _, _, p in traj))
    want = ({"edt_row": BF16_STEPS} if name == "fba" else {})
    want["fam_window_logits"] = BF16_STEPS
    if counts != want or logits["fam_window_logits_bfloat16"]:
        fail(f"{name} bf16 trajectory launches {counts}, {logits}; want "
             f"{want} and no bf16 logits")
    if not kept["parameters"] or any(v - {"torch.float32"}
                                     for v in kept.values()):
        fail(f"{name} bf16 state dtypes {kept}: want f32")
    if abs(rows[0]["loss_rel"]) > BF16_GATES["max_loss_rel_step0"]:
        fail(f"{name} bf16 step-0 loss error {rows[0]['loss_rel']}")
    dev = max(abs(r - 1.0) for r in ratio)
    if not np.isfinite(dev) or dev > BF16_GATES["max_traj_ratio_dev"]:
        fail(f"{name} bf16 trajectory ratio {ratio}")
    return counts


def train_remat_phase(name: str, cuda_build) -> dict:
    """``--remat`` on ``vmn_<name>`` (``train_setup``): from one state and
    one batch, with PyTorch's deterministic algorithms, two plain steps
    and one remat step. The remat step's losses, each module's update,
    the statistics, u, v and the next dropout mask within the larger of
    twice the plain steps' spread and 1e-6 relative; its peak memory
    (``max_memory_allocated``, reset per step) below the plain step's.
    Returns the remat step's launches."""
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    task, kw, batch, radius, weights = train_setup(name)
    trainers = {False: MattingTrainer(task, "vmd", **kw),
                True: MattingTrainer(task, "vmd", remat=True, **kw)}

    def one(remat: bool):
        """One step from ``weights``; what it returns is kept on the CPU,
        so that each run's peak memory holds its own step alone."""
        st = fresh_state(trainers[remat], weights)
        before = {n: p.detach().cpu() for n, p in
                  st.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.LAUNCHES.clear()
        # warn_only: FBA's bilinear upsampling has no deterministic
        # backward; the plain steps' spread then holds its share
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            _, m = trainers[remat].train_step(st, batch, radius)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.use_deterministic_algorithms(False)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(cuda_build.LAUNCHES)
        update = {n: (p.detach().cpu() - before[n]).double() for n, p in
                  st.model.named_parameters()}
        mask = None
        if st.dropout_generator is not None:
            mask = torch.empty(4096, device="cuda").bernoulli_(
                0.5, generator=st.dropout_generator).cpu()
        out = ({k: v.item() for k, v in m.items() if k != "lr"}, update,
               {n: b.cpu() for n, b in train_buffers(st.model).items()},
               mask, peak, ms, launches)
        del st
        return out

    runs = [one(False), one(False), one(True)]

    def errors(a, b):
        (ma, ua, ba, ka, *_), (mb, ub, bb, kb, *_) = a, b
        return {"loss": max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
                            for k in mb),
                "update": module_grad_errors(ua, ub)[0][0],
                "buffer": max((((v - bb[n]).abs().max()
                               / bb[n].abs().max().clamp_min(1e-30)).item()
                              for n, v in ba.items()), default=0.0),
                "mask": 0.0 if ka is None else float(
                    (ka != kb).float().mean().item())}

    spread = errors(runs[1], runs[0])
    err = errors(runs[2], runs[0])
    limit = {k: max(2 * v, 1e-6) for k, v in spread.items()}
    limit["mask"] = 0.0
    (_, _, _, _, peak, ms, _), (_, _, _, _, peak_r, ms_r, launches) = (
        runs[0], runs[2])
    emit(phase=f"train_{name}_remat", batch=batch["a"].shape[0],
         remat_err=err, plain_spread=spread, limit=limit,
         peak_gib=peak, remat_peak_gib=peak_r,
         plain_step_ms=[r[5] for r in runs[:2]], remat_step_ms=ms_r,
         launches=launches)
    del runs
    torch.cuda.empty_cache()
    bad = {k: v for k, v in err.items() if v > limit[k]}
    if bad:
        fail(f"{name} remat step against plain: {bad}, limits {limit}")
    if not peak_r < peak:
        fail(f"{name} remat peak {peak_r} GiB, plain {peak}")
    return launches


def train_cli_bf16_remat_phase(tmp) -> dict:
    """``python -m tcvom_tpu_torch.tools.train --remat`` with ``TRAIN.BF16
    True``: the IndexNet video config (B = 4) on ``train_cli``'s fake tree
    (2 steps an epoch), one epoch from random weights; its
    ``train_stats.json``'s last losses finite. Returns the run's
    launches."""
    logs = tmp / "train_log_bf16_remat"
    cfg = "vmd_vmn_index_pretrained_30ep.yaml"
    secs = tool_run([sys.executable, "-m", "tcvom_tpu_torch.tools.train",
                     "--cfg", str(ROOT / "cfgs" / cfg), "--remat",
                     "SYSTEM.OUTDIR", str(logs), "DATASET.PATH",
                     str(tmp / "vmd_train"), "TRAIN.LOAD_CKPT", "",
                     "TRAIN.TOTAL_STEPS", "1", "TRAIN.BF16", "True"],
                    "tools.train TRAIN.BF16 --remat")
    with open(logs / (Path(cfg).stem + "_agg7") / "train_stats.json") as f:
        stats = json.load(f)
    emit(phase="train_cli_bf16_remat", cfg=cfg, seconds=secs, **stats)
    if stats["step"] != 2 or not all(np.isfinite(v) for v in
                                     stats["last_losses"].values()):
        fail(f"train_cli_bf16_remat: step {stats['step']}, losses "
             f"{stats['last_losses']}")
    return stats["launches"]


# the logged losses of two ranks against one process at their global
# batch (the JAX package's own two-process tolerance, tests/
# test_multihost.py), and of a DDP run of one rank against a plain run
DDP_LOSS_RTOL = {1: 1e-4, 2: 2e-4}


def tool_run(cmd: list, what: str, timeout: int = 900):
    """``cmd`` from the repo root with this package importable; its stdout
    and stderr on failure, which fails the phase. Returns its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        fail(f"{what} exited {proc.returncode}")
    return time.perf_counter() - t0


def torchrun(n: int, module: str) -> list:
    """The command of ``module`` on ``n`` ranks of this machine."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={n}", "-m", module]


def logged_losses(out) -> list[float]:
    """``Current: Loss`` of each logged step, from the rank-0 log."""
    return [float(v) for v in logged(out, r"Current: Loss: ([0-9.]+)")]


def logged(out, pattern: str, suffix: str = "_train.log") -> list[str]:
    """Each match of ``pattern``'s group in the run's log (rank 0's, or
    another rank's by ``suffix``)."""
    import re

    (log,) = [p for p in out.iterdir() if p.name.endswith(suffix)]
    return re.findall(pattern, log.read_text())


def checkpoint_errors(got: dict, want: dict, base: dict | None = None):
    """(each module's parameters' relative L2 error, worst first; each
    running statistic's and u's, v's largest error over max(1, its
    largest value), worst first) of two train states' models; with
    ``base`` (the weights both started from) the parameters' updates are
    compared instead."""
    mods = {}
    for k, v in want.items():
        if v.is_floating_point() and not k.endswith(STAT_KEYS):
            mods.setdefault(k.rsplit(".", 1)[0], []).append(k)

    def vec(d, names):
        return torch.cat([(d[n].double() - (0 if base is None else
                                             base[n].double())).flatten()
                          for n in names])

    params = sorted((((vec(got, ns) - vec(want, ns)).norm()
                      / vec(want, ns).norm().clamp_min(1e-30)).item(), m)
                    for m, ns in mods.items())[::-1]
    stats = sorted(((got[k].double() - want[k].double()).abs().max().item()
                    / max(1.0, want[k].abs().max().item()), k)
                   for k in want if k.endswith(STAT_KEYS))[::-1]
    return params, stats


STAT_KEYS = ("running_mean", "running_var", "weight_u", "weight_v")


GCA_CFG = "vmd_vmn_gca_pretrained_30ep.yaml"
# torch's TF32 settings of a fresh process (cuDNN convolutions, cuBLAS
# matmuls), which the tools' subprocesses keep; main turns both off
FRESH_TF32 = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def fresh_tf32():
    """This process with a fresh process's TF32 settings, as a tool's
    subprocess runs, for a one-process run to compare with it."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = FRESH_TF32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
# the relative Gaussian jitters of a batch's fg and bg (one draw, scaled)
# whose moves set the floors of train_ddp_gca2's update checks: rounding
# of the inputs' size. Two, since one module's move is no smooth function
# of the jitter (GCA's encoder.layer2.0.downsample.2: 2.6e-3 at 1e-6,
# 6.6e-2 at 2e-6; PERF.md §6)
INPUT_ROUNDING = (1e-6, 2e-6)


@functools.lru_cache(maxsize=1)
def gca_b12_batch(tree):
    """GCA_CFG with SGD at B = 12 on ``tree`` as ``tools.train`` reads it:
    (the config, its batches an epoch, the sampler's first batch), read
    once for every ``gca_b12_steps`` call on ``tree``."""
    from types import SimpleNamespace

    from tcvom_tpu_torch.config import load_config
    from tcvom_tpu_torch.data.loader import make_loader
    from tcvom_tpu_torch.tools import train as T

    cfg = load_config(str(ROOT / "cfgs" / GCA_CFG), [
        "DATASET.PATH", str(tree), "TRAIN.OPTIMIZER", "sgd",
        "TRAIN.BATCH_SIZE_PER_GPU", "12", "TRAIN.TOTAL_STEPS", "1"])
    seed = cfg.SYSTEM.RANDOM_SEED
    data, _ = T._datasets(cfg, SimpleNamespace(
        dataset="vmd", driver="vmd", sample_length=None), seed)
    loader = make_loader(data, 12, shuffle=True, seed=seed, drop_last=True)
    return cfg, len(loader), next(iter(loader))


def gca_b12_steps(tree, ckpt, jitter: float = 0.0):
    """``tools.train``'s first step of GCA_CFG with SGD at B = 12 on
    ``tree``, in this process, as the command makes it (the config, the
    seed's weights and radius generator, ``ckpt`` loaded, the sampler's
    first batch, deterministic algorithms, a fresh process's TF32
    settings), with the batch's fg and bg
    jittered by relative ``jitter``; then a second step on the same
    batch, timed. Returns (the first step's loss, the weights and
    buffers after it, the second step's ms, the peak memory in GiB)."""
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.tools import train as T
    from tcvom_tpu_torch.train.trainer import MattingTrainer
    from tcvom_tpu_torch.utils.checkpoint import load_weights

    cfg, batches, batch = gca_b12_batch(tree)
    seed = cfg.SYSTEM.RANDOM_SEED
    batch = T._on(batch, torch.device("cuda"))
    if jitter:
        gen = torch.Generator(device="cuda").manual_seed(1)
        for k in ("fg", "bg"):
            batch[k] = batch[k] * (1.0 + jitter * torch.randn(
                batch[k].shape, generator=gen, device="cuda"))
    trainer = MattingTrainer(
        TaskConfig(model=cfg.MODEL, agg_window=cfg.AGG_WINDOW),
        "vmd", optimizer=cfg.TRAIN.OPTIMIZER,
        lr_strategy=cfg.TRAIN.LR_STRATEGY, base_lr=cfg.TRAIN.BASE_LR,
        weight_decay=cfg.TRAIN.WEIGHT_DECAY,
        total_iters=cfg.TRAIN.TOTAL_STEPS * batches)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    load_weights(state.model, str(ckpt))
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with fresh_tf32():
            _, metrics = trainer.train_step(state, batch)
            after = {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}
            t0 = time.perf_counter()
            trainer.train_step(state, batch)
            torch.cuda.synchronize()
            second_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.use_deterministic_algorithms(False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = round(metrics["loss"].item(), 6)
    del state, trainer, batch
    torch.cuda.empty_cache()
    return loss, after, second_ms, peak


def update_error(got: dict, want: dict, base: dict) -> float:
    """The relative L2 error of every parameter's update at once."""
    keys = [k for k, v in want.items()
            if v.is_floating_point() and not k.endswith(STAT_KEYS)]

    def vec(d):
        return torch.cat([(d[k].double() - base[k].double()).flatten()
                          for k in keys])

    return ((vec(got) - vec(want)).norm() / vec(want).norm()).item()


# train_ddp_gca2's update limits: twice the farthest move of a jittered
# one-process step (INPUT_ROUNDING), at least UPDATE_FLOOR; for the whole
# update at most UPDATE_CEILING
UPDATE_FLOOR, UPDATE_CEILING = 1e-4, 1e-2


VAL_L_DT = r"epoch \d+ val L_dt: ([0-9.]+)"


def train_ddp_phases(tmp) -> dict:
    """``tools.train`` under ``torch.distributed.run`` on fake trees, each
    run a subprocess (``--deterministic``, 2 loader workers a rank), its
    losses from the log and its train state from ``checkpoint_1.pth``:

    - train_ddp_fba: cfgs/vmd_vmn_fba_pretrained_30ep.yaml at full width
      (B = 1, S = 5, 512x512) for an epoch of the 6-frame training clip
      of ``train_cli``, validating it (``--tool train``: the 6 samples
      of the validation clip at 544x960): one rank over NCCL
      against the same command without ``torch.distributed.run``: losses
      and validation L_dt within rtol 1e-4, each module's weights and
      ``best.pth``'s within 1e-4 relative L2 (a plain rerun was
      bit-identical, PERF.md §6); the DDP step's ms beside the plain
      step's (the steps after the first);
    - train_ddp_gca2: GCA_CFG at its per-card batch (B = 6, S = 5,
      512x512) with SGD in place of Adam, two ranks over gloo on the one
      card, two epochs of one step on a 12-frame clip, against the
      command's first step at B = 12 made in this process
      (``gca_b12_steps``; the same as the command's, bit for bit, PERF.md
      §6) after them, and again with the batch's fg and bg jittered by
      each of ``INPUT_ROUNDING``: the losses within rtol 2e-4, every
      BatchNorm statistic and u, v within 1e-5, the whole update within
      twice the jittered steps' farthest move (at least 1e-4, at most
      1e-2), each module's update (its parameters' as one vector) within
      twice their farthest move of that module (at least 1e-4; no ceiling:
      at f32 the jitter moves 16 of GCA's 150 modules past 1e-2, PERF.md
      §6); the steps' ms after the first, each rank's peak memory. SGD,
      whose update is the gradient's: Adam's first step moves every
      weight by about lr whatever its gradient's size.

    Returns the launches of rank 0's process in each run
    (``train_stats.json``), the validations' apart (``val_launches``)."""
    from tcvom_tpu_torch.tools.make_fake_dataset import make

    logs = tmp / "ddp_log"
    launches = {}

    def run(name, cfg, tree, ckpt, ranks, *opts, backend=None, val=False):
        """With ``val`` through this script's ``--tool train``, which
        validates every epoch."""
        out_root = logs / name
        module, tool = (("chip_smoke", ["--tool", "train"]) if val
                        else ("tcvom_tpu_torch.tools.train", []))
        cmd = ((torchrun(ranks, module)
                + (["--dist_backend", backend] if backend else []))
               if ranks else [sys.executable, "-m", module]) + tool
        secs = tool_run(cmd + [
            "--cfg", str(ROOT / "cfgs" / cfg), "--deterministic",
            "SYSTEM.OUTDIR", str(out_root), "SYSTEM.NUM_WORKERS", "2",
            "DATASET.PATH", str(tree), "TRAIN.LOAD_CKPT", str(ckpt),
            "TRAIN.PRINT_FREQ", "1", *map(str, opts)],
            f"tools.train {name}")
        out = out_root / (Path(cfg).stem + "_agg7")
        stats = json.loads((out / "train_stats.json").read_text())
        state = torch.load(out / "checkpoint_1.pth", map_location="cpu")
        val = [float(v) for v in logged(out, VAL_L_DT)]
        emit(phase="train_ddp", run=name, torchrun=bool(ranks),
             seconds=secs, losses=logged_losses(out), val_l_dt=val, **stats)
        best = (torch.load(out / "best.pth", map_location="cpu")
                if (out / "best.pth").exists() else None)
        return logged_losses(out), state["model"], stats, val, best

    # -- FBA, one rank over NCCL against the plain command -----------------
    fba_cfg = "vmd_vmn_fba_pretrained_30ep.yaml"
    fba_ckpt = tmp / "vmn_fba.pth"
    plain = run("fba_plain", fba_cfg, tmp / "vmd_train", fba_ckpt, 0,
                "TRAIN.TOTAL_STEPS", 1, val=True)
    ddp = run("fba_ddp", fba_cfg, tmp / "vmd_train", fba_ckpt, 1,
              "TRAIN.TOTAL_STEPS", 1, val=True)
    err, _ = checkpoint_errors(ddp[1], plain[1])
    best_err = (checkpoint_errors(ddp[4], plain[4])[0]
                if ddp[4] is not None and plain[4] is not None else None)
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in
           zip(ddp[0] + ddp[3], plain[0] + plain[3])]
    val_counts = ddp[2]["val_launches"]
    train_counts = {k: v - val_counts.get(k, 0)
                    for k, v in ddp[2]["launches"].items()}
    emit(phase="train_ddp_fba", steps=len(ddp[0]),
         ddp_step_ms=ddp[2]["later_step_s"] * 1e3,
         plain_step_ms=plain[2]["later_step_s"] * 1e3,
         ddp_first_step_ms=ddp[2]["first_step_s"] * 1e3,
         plain_first_step_ms=plain[2]["first_step_s"] * 1e3,
         val_l_dt=ddp[3], plain_val_l_dt=plain[3],
         loss_rel_err_worst=max(rel), module_err_worst=err[:3],
         best_err_worst=best_err[:3] if best_err else None,
         launches=train_counts, val_launches=val_counts)
    if len(ddp[0]) != len(plain[0]) or len(ddp[3]) != 1 or \
            len(plain[3]) != 1 or max(rel) > DDP_LOSS_RTOL[1]:
        fail(f"train_ddp_fba losses {ddp[0]}, val {ddp[3]} against "
             f"{plain[0]}, {plain[3]}")
    if err[0][0] > 1e-4 or best_err is None or best_err[0][0] > 1e-4:
        fail(f"train_ddp_fba weights {err[:3]}, best.pth {best_err}")
    for counts, least in ((train_counts, len(ddp[0])), (val_counts, 1)):
        if min(counts.get(k, 0) for k in ("edt_row", "fam_window_logits")) \
                < least:
            fail(f"train_ddp_fba launches {train_counts}, validation "
                 f"{val_counts} in {len(ddp[0])} steps")
    launches["train_ddp_fba"] = train_counts
    launches["val_ddp_fba"] = val_counts

    # -- GCA, two gloo ranks on the card against one process at B = 12 -------
    tree = tmp / "vmd_ddp"
    make(str(tree), frames=12, hw=FRAME_HW, seed=4)
    gca_ckpt = tmp / "vmn_gca.pth"
    two = run("gca_2ranks", GCA_CFG, tree, gca_ckpt, 2, "TRAIN.OPTIMIZER",
              "sgd", "TRAIN.TOTAL_STEPS", 2, backend="gloo")
    torch.cuda.empty_cache()
    loss, one, one_ms, one_peak = gca_b12_steps(tree, gca_ckpt)
    jittered = [gca_b12_steps(tree, gca_ckpt, j)[1] for j in INPUT_ROUNDING]
    base = torch.load(gca_ckpt, map_location="cpu")
    err, stat_err = checkpoint_errors(two[1], one, base)
    whole = update_error(two[1], one, base)
    floor = max(update_error(j, one, base) for j in jittered)
    limit = min(UPDATE_CEILING, max(UPDATE_FLOOR, 2 * floor))
    floors = {}
    for j in jittered:
        for e, m in checkpoint_errors(j, one, base)[0]:
            floors[m] = max(floors.get(m, 0.0), e)
    # (error / limit, error, the jitters' move, module) of every module
    held = sorted(((e / max(UPDATE_FLOOR, 2 * floors[m]), e, floors[m], m)
                   for e, m in err), reverse=True)
    rel = abs(two[0][0] - loss) / loss
    emit(phase="train_ddp_gca2", ranks=2, batch_per_rank=6,
         two_rank_step_ms=two[2]["later_step_s"] * 1e3,
         two_rank_first_step_ms=two[2]["first_step_s"] * 1e3,
         one_process_b12_step_ms=one_ms,
         rank0_max_memory_allocated_gib=two[2].get(
             "max_memory_allocated_gib"),
         b12_max_memory_allocated_gib=one_peak, losses=two[0],
         want_loss=loss, loss_rel_err=rel, update_err=whole,
         jittered_update_err=floor, limit=limit, module_err_worst=err[:5],
         module_err_median=float(np.median([e for e, _ in err])),
         modules=len(held), modules_over_ceiling=sum(
             e > UPDATE_CEILING for e, _ in err),
         held_worst=held[:5], stat_err_worst=stat_err[:3],
         launches=two[2]["launches"])
    if len(two[0]) != 2 or rel > DDP_LOSS_RTOL[2]:
        fail(f"train_ddp_gca2 losses {two[0]} against {loss}")
    if not stat_err or stat_err[0][0] > 1e-5:
        fail(f"train_ddp_gca2 statistics {stat_err[:3]}")
    if whole > limit:
        fail(f"train_ddp_gca2 update {whole}, limit {limit}")
    if not held or held[0][0] > 1:
        fail(f"train_ddp_gca2 module updates {held[:5]}")
    if two[2]["launches"].get("fam_window_logits", 0) < 2:
        fail(f"train_ddp_gca2 launches {two[2]['launches']}")
    launches["train_ddp_gca2"] = two[2]["launches"]
    return launches


def read_losses(folder) -> dict:
    """loss.log of a pred_vmn sweep."""
    return {k: float(v) for k, v in (
        line.split(": ") for line in
        (folder / "loss.log").read_text().splitlines() if line)}


def pred_vmn_ddp_phase(tmp, root) -> dict:
    """tools/pred_vmn.py as ``pred_vmn`` ran it (FBA, the fake clip's 4
    samples, B = 1, 1088x1920, no loader workers), on two gloo ranks of
    the one card, two samples each, against the same sweep in this
    process with a fresh process's TF32 settings: the PNGs byte for
    byte, the losses in loss.log within rtol 1e-6. Each rank runs
    ``pred_vmn.main`` through this script's ``--tool``, which writes its
    process's kernel launches; returns their sum."""
    from tcvom_tpu_torch.tools import pred_vmn

    args = ["--model", "fba", "--data", str(root), "--load",
            str(tmp / "vmn_fba.pth"), "--trimap", "medium", "--agg_window",
            str(WINDOW), "--batch", "1", "--n_threads", "0"]
    save, out = tmp / "pred_vmn_one", tmp / "pred_vmn_ddp"
    counts_dir = tmp / "pred_vmn_ddp_launches"
    with fresh_tf32():
        pred_vmn.main(args + ["--save", str(save)])
    secs = tool_run(torchrun(2, "chip_smoke") + [
        "--tool", "pred_vmn", "--launches", str(counts_dir),
        "--dist_backend", "gloo", *args, "--save", str(out)],
        "pred_vmn on two ranks")
    names = sorted(p.name for p in (save / "clip_b").iterdir())
    differ = [n for n in names if (save / "clip_b" / n).read_bytes()
              != (out / "clip_b" / n).read_bytes()]
    got, want = read_losses(out), read_losses(save)
    rel = max(abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items())
    ranks = [json.loads((counts_dir / f"rank_{r}.json").read_text())
             for r in range(2)]
    counts = {k: sum(r.get(k, 0) for r in ranks)
              for k in ("edt_row", "fam_window_logits")}
    emit(phase="pred_vmn_ddp", ranks=2, backend="gloo", seconds=secs,
         files=len(names), differing=differ, losses=got,
         loss_rel_err_worst=rel, rank_launches=ranks)
    if len(names) != 8 or differ or sorted(got) != sorted(want) or rel > 1e-6:
        fail(f"pred_vmn on two ranks: {differ} differ, losses {got} "
             f"against {want}")
    # each rank's two samples: one trimap row pass and one logits call each
    if any(r.get(k, 0) < 2 for r in ranks for k in counts):
        fail(f"pred_vmn on two ranks: launches {ranks}")
    return counts


# The relative jitter of DIM's and GCA's weights whose move sets the
# limits of their pred_vmn --space checks: rounding's size (f32
# convolutions in another order move DIM's pool inputs by ~1e-6 relative;
# its argmax pools then flip near-ties, as the band split's other cuDNN
# algorithms do; GCA's attention amplifies such a move)
JITTER = 1e-6


# the FAM widths of pred_vmn --space 2's bands: FBA's and DIM's,
# IndexNet's, GCA's
BAND_WIDTHS = (256, 32, 128)


def check_fam_band(fam, fam_kernel, c: int) -> dict:
    """Kernel D at ``pred_vmn --space 2``'s band of the 1088x1920 grid at
    FAM width ``c``: each rank's [2, 68, 240, c] band and its halo on its
    inner side, as ``ops/fam.py::fam_attention`` builds it (k's extra rows
    the other band's, q's and the mask's zeros): 3 rows below the first
    band, [2, 71, 240, c], and 4 above the second (an even count keeps the
    rows' parity in the kernel's two-row warp tiles), [2, 72, 240, c].
    For both bands the call is held bit for bit against the call on the
    whole grid, cropped, and against the plain version (1e-5), and timed
    with its bound. Returns the first band's row."""
    import torch.nn.functional as F

    rng = np.random.RandomState(5 + c)
    shape = (2, H // 8, W // 8, c)
    q, k = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
            for _ in range(2))
    m = torch.from_numpy((rng.rand(*shape[:3], 1) > 0.4).astype(
        np.float32)).cuda()
    whole = fam_kernel.fam_window_logits(q, k, m, WINDOW)
    r, h = WINDOW // 2, shape[1] // 2
    rows = []
    for lo, top, bottom in ((0, 0, r), (h, r + r % 2, 0)):
        kb = k[:, lo - top:lo + h + bottom].contiguous()
        qb, mb = (F.pad(t[:, lo:lo + h], (0, 0, 0, 0, top, bottom))
                  for t in (q, m))
        band = (qb, kb, mb)
        got = fam_kernel.fam_window_logits(*band, WINDOW)
        for what, g, wt in zip(("out", "logits"), got, whole):
            if not torch.equal(g[:, top:top + h], wt[:, lo:lo + h]):
                fail(f"fam_window_logits at C = {c} on band {lo}: {what} "
                     "differs from the whole grid's")
        want = fam.fam_attention_ref(*band, WINDOW)
        err = max((g - wt).abs().max().item() for g, wt in zip(got, want))
        if err > 1e-5:
            fail(f"fam_window_logits at the band shape {tuple(qb.shape)} "
                 f"off the plain version by {err}")
        ms = time_ms(lambda: fam_kernel.fam_window_logits(*band, WINDOW), 20)
        plain_ms = time_ms(lambda: fam.fam_attention_ref(*band, WINDOW), 3)
        b_ms, b_by = bound(*fam_counts(mb, c, WINDOW, logits=True),
                           torch.float32)
        rows.append(dict(shape=list(qb.shape), dtype=str(torch.float32),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
        emit(phase="time", kernel="fam_window_logits", what="space band",
             band=lo, bit_equal_to_whole=True, **rows[-1])
    return rows[0]


def png_diffs(want_dir, got_dir) -> dict:
    """Per PNG of ``want_dir``: (the largest level difference, the share
    of identical pixels) against the same file of ``got_dir``."""
    from tcvom_tpu_torch.utils.imageio import IMREAD_GRAYSCALE, imread

    out = {}
    for p in sorted(want_dir.iterdir()):
        want, got = (imread(str(d / p.name), IMREAD_GRAYSCALE).astype(int)
                     for d in (want_dir, got_dir))
        diff = np.abs(got - want)
        out[p.name] = (int(diff.max()), float((diff == 0).mean()))
    return out


def pred_vmn_space_phase(tmp, root, refs: dict) -> dict:
    """``pred_vmn --space 2`` (all four models, f32, the fake clip's 4
    samples, B = 1, 1088x1920, window 7, no loader workers) on two gloo
    ranks of the one card, each computing one 544-row band of every
    frame (one launch: each rank runs the four sweeps one after the other
    in one process group, each from zero launch counts), against the
    one-process sweep of the same arguments: FBA's,
    IndexNet's and GCA's are ``refs`` (``{model: (.pth, folder, its
    seconds by phase and peak)}``: ``pred_vmn``'s and
    ``pred_vmn_backbone_phase``'s), DIM's (seed-0 weights calibrated on
    the clip's first sample) runs here. Both sides without TF32 (this
    process's setting; the ranks' ``--no_tf32``). Holds each PNG within
    one level and >= 99.9 % identical, loss.log within rtol 1e-4; DIM and
    GCA within twice what their rounding moves them where that is more
    (at least one level, 99.9 %, 1e-4): DIM's 2x2 argmax pools flip
    near-ties under a change of cuDNN's algorithms (a band's shape is not
    the frame's), GCA's attention amplifies rounding (ROADMAP Queue 3), so
    their limits are set in the same run by the one-process sweep again
    with every weight moved by a relative ``JITTER``. Holds each rank's
    launches (``fam_window_logits`` 4, ``edt_row`` 4 for FBA and 0 for
    the rest, DIM's pool and unpool kernels 20 each); prints each rank's
    band, kernel D's shapes, step seconds a sample and peak beside the
    one-process sweep's, and the band exchanges a sample. Returns both
    ranks' launches by model."""
    from tcvom_tpu_torch.data.vmd import VideoMattingDataset
    from tcvom_tpu_torch.infer.predict import TRIMAP_DILATION
    from tcvom_tpu_torch.models.full_model import TaskConfig, forward_vmd
    from tcvom_tpu_torch.models.registry import (build_model,
                                                 calibrate_random_weights)
    from tcvom_tpu_torch.tools import pred_vmn
    from tcvom_tpu_torch.utils.checkpoint import save_weights

    samples = 4
    dataset = VideoMattingDataset(str(root), (H, W), "val",
                                  precomputed_val=str(root), sample_length=3,
                                  no_flow=True)
    batch = {k: torch.from_numpy(np.asarray(v))[None].float().cuda()
             for k, v in dataset[(0, 0)].items() if k in ("a", "fg", "bg")}
    model = build_model("vmn_dim", agg_window=WINDOW,
                        generator=torch.Generator().manual_seed(0))
    cfg = TaskConfig(model="vmn_dim", agg_window=WINDOW,
                     dilate_radius=TRIMAP_DILATION["medium"])
    calibrate_random_weights(model, lambda: forward_vmd(model, batch, cfg))
    save_weights(model, str(tmp / "vmn_dim_space.pth"))
    del model, batch
    torch.cuda.empty_cache()

    def args(model, ckpt, save):
        return ["--model", model, "--data", str(root), "--load", str(ckpt),
                "--trimap", "medium", "--agg_window", str(WINDOW),
                "--image_shape", str(H), str(W), "--batch", "1",
                "--n_threads", "0", "--save", str(save)]

    dim_save, dim_sweep = tmp / "pred_vmn_dim_one", {}
    torch.cuda.reset_peak_memory_stats()
    pred_vmn.main(args("dim", tmp / "vmn_dim_space.pth", dim_save),
                  dim_sweep)
    dim_sweep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    refs = dict(refs, dim=(tmp / "vmn_dim_space.pth", dim_save, dim_sweep))
    limits = {m: (1, 0.999, 1e-4) for m in refs}
    for model in ("dim", "gca"):
        # the rounding reference: the one-process sweep again with every
        # weight moved by a relative JITTER (seeded)
        ckpt, save, _ = refs[model]
        sd = torch.load(ckpt)
        gen = torch.Generator().manual_seed(6)
        jittered = tmp / f"vmn_{model}_jitter.pth"
        torch.save({k: v * (1 + JITTER * torch.randn(v.shape, generator=gen))
                    if k.endswith(("weight", "bias", "weight_bar")) else v
                    for k, v in sd.items()}, jittered)
        jitter_save = tmp / f"pred_vmn_{model}_jitter"
        pred_vmn.main(args(model, jittered, jitter_save))
        pngs = png_diffs(save / "clip_b", jitter_save / "clip_b")
        got, want = read_losses(jitter_save), read_losses(save)
        jitter = dict(level=max(d for d, _ in pngs.values()),
                      identical=min(f for _, f in pngs.values()),
                      loss_rel=max(abs(got[k] - v) / max(abs(v), 1e-30)
                                   for k, v in want.items()))
        limits[model] = (max(1, 2 * jitter["level"]),
                         min(0.999, 1 - 2 * (1 - jitter["identical"])),
                         max(1e-4, 2 * jitter["loss_rel"]))
        emit(phase=f"pred_vmn_space_{model}_rounding", jitter=JITTER,
             png_worst_level=jitter["level"],
             png_identical_least=jitter["identical"],
             loss_rel_err_worst=jitter["loss_rel"], limits=limits[model])
    # the four sweeps one after the other in one launch of two ranks; this
    # process's cached blocks are released first. GCA's peak is a cuDNN
    # workspace (tools/memory_probe.py): cuDNN runs the first plan whose
    # workspace it can allocate, so a rank that found the card short of
    # memory would run another plan and peak lower
    free_cached = torch.cuda.mem_get_info()[0] / 2**30
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2**30
    models = ("fba", "dim", "index", "gca")
    runs = []
    for model in models:
        runs += ["--then"] * bool(runs) + ["--space", "2", *args(
            model, refs[model][0], tmp / f"pred_vmn_space_{model}")]
    secs = tool_run(torchrun(2, "chip_smoke") + [
        "--tool", "pred_vmn", "--launches",
        *(str(tmp / f"pred_vmn_space_{m}_launches") for m in models),
        "--no_tf32", "--dist_backend", "gloo", *runs],
        "pred_vmn --space 2, four models")
    emit(phase="pred_vmn_space_launch", models=models, seconds=secs,
         card_free_gib=free, card_free_gib_before_empty_cache=free_cached)
    counts = {}
    for model in models:
        _, save, sweep = refs[model]
        out, counts_dir = (tmp / f"pred_vmn_space_{model}",
                           tmp / f"pred_vmn_space_{model}_launches")
        ranks = []
        for r in range(2):
            st = json.loads((counts_dir / f"rank_{r}_stats.json").read_text())
            ranks.append(dict(
                band=st["band"],
                launches=json.loads((counts_dir / f"rank_{r}.json"
                                     ).read_text()),
                fam_shapes=sorted({tuple(s) for s in st["fam_shapes"]}),
                step_s_per_sample=st["step"] / samples,
                peak_gib=st["peak_gib"],
                exchanges_per_sample={k: [c / samples, b / samples]
                                      for k, (c, b) in
                                      st["exchanges"].items()}))
        pngs = png_diffs(save / "clip_b", out / "clip_b")
        got, want = read_losses(out), read_losses(save)
        rel = max(abs(got[k] - v) / max(abs(v), 1e-30)
                  for k, v in want.items())
        emit(phase="pred_vmn_space", model=model, space=2, backend="gloo",
             ranks=ranks,
             one_process=dict(step_s_per_sample=sweep["step"] / samples,
                              peak_gib=sweep["peak_gib"]),
             png_worst_level=max(d for d, _ in pngs.values()),
             png_identical_least=min(f for _, f in pngs.values()),
             files=len(pngs), losses=got, loss_rel_err_worst=rel,
             limits=limits[model])
        level, identical, rtol = limits[model]
        bad = {n: v for n, v in pngs.items()
               if v[0] > level or v[1] < identical}
        if len(pngs) != 2 * samples or bad or sorted(got) != sorted(want) \
                or rel > rtol:
            fail(f"pred_vmn --space 2 --model {model}: PNGs {bad}, losses "
                 f"{got} against {want}")
        want_counts = with_pools(with_norms(
            {"fam_window_logits": samples,
             "edt_row": samples if model == "fba" else 0},
            FBA_PPM_NORMS * samples if model == "fba" else 0),
            model, samples, samples)
        if any(rk["launches"].get(k, 0) != n for rk in ranks
               for k, n in want_counts.items()):
            fail(f"pred_vmn --space 2 --model {model}: launches "
                 f"{[rk['launches'] for rk in ranks]}, want {want_counts} "
                 "on each rank")
        counts[model] = {k: sum(rk["launches"].get(k, 0) for rk in ranks)
                         for k in want_counts}
    return counts


def tool_rank(tool: str, counts_dirs: list | None, argv: list,
              tf32: bool = True) -> None:
    """``--tool``: ``tcvom_tpu_torch.tools.<tool>.main(argv)`` in this
    process (a rank, under ``torch.distributed.run``), from zero launch
    counts; ``tools.train`` validating from its first epoch. ``pred_vmn``
    takes several runs, their arguments separated by ``--then``, one
    after the other in one process group, each from zero launch counts.
    With ``counts_dirs`` (one a run), a run's kernel launches then go to
    ``<its dir>/rank_<RANK>.json``, and for ``pred_vmn`` its sweep's stats
    (seconds by phase, the band and its exchanges under ``--space``), its
    peak device memory and the shapes of q its logits kernel took to
    ``<its dir>/rank_<RANK>_stats.json``. ``tf32`` False (``--no_tf32``):
    cuDNN's convolutions and cuBLAS's matmuls without TF32, as this
    script's own runs compute."""
    import importlib

    from tcvom_tpu_torch.ops import cuda_build, fam_kernel
    from tcvom_tpu_torch.tools.common import init_ranks

    if not tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mod = importlib.import_module(f"tcvom_tpu_torch.tools.{tool}")
    if tool == "train":
        mod.VAL_FROM_EPOCH = 0
    runs = [list(g) for split, g in itertools.groupby(
        argv, lambda a: a == "--then") if not split]
    if tool != "pred_vmn" and len(runs) > 1:
        raise SystemExit(f"--then takes pred_vmn runs, not {tool}")
    counts_dirs = counts_dirs or [None] * len(runs)
    if len(counts_dirs) != len(runs):
        raise SystemExit(f"{len(counts_dirs)} --launches folders for "
                         f"{len(runs)} runs")
    rank = os.environ.get("RANK", "0")

    def write(counts_dir, name, value):
        if counts_dir:
            os.makedirs(counts_dir, exist_ok=True)
            Path(counts_dir, name).write_text(json.dumps(value))

    if tool != "pred_vmn":
        cuda_build.LAUNCHES.clear()
        mod.main(argv)
        write(counts_dirs[0], f"rank_{rank}.json", dict(cuda_build.LAUNCHES))
        return
    logits = fam_kernel.fam_window_logits
    # one process group for every run (a tool leaves a group it did not
    # make as it found it)
    with init_ranks(mod.parse_args(runs[0])):
        for run, counts_dir in zip(runs, counts_dirs):
            stats, shapes = {}, []

            def recording(q, *a, **kw):
                shapes.append(list(q.shape))
                return logits(q, *a, **kw)

            gc.collect()                # the last run's tensors freed
            cuda_build.LAUNCHES.clear()
            torch.cuda.reset_peak_memory_stats()
            with mock.patch.object(fam_kernel, "fam_window_logits",
                                   recording):
                mod.main(run, stats)
            stats.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         fam_shapes=shapes)
            write(counts_dir, f"rank_{rank}.json", dict(cuda_build.LAUNCHES))
            write(counts_dir, f"rank_{rank}_stats.json", stats)


def stream_tflop(model, in_channels: int) -> tuple[float, float]:
    """TFLOP of one encode (encoder, extract half, FAM projections; GCA's
    attention products included) and of one decoder head of the VMN
    ``model`` at H x W, counted by torch.utils.flop_counter on a copy on
    the meta device (the FAM attention between them is the kernel's,
    counted in its own row)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(model).to("meta")
    x = torch.zeros(1, in_channels, H, W, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as enc:
        feats, qkv = meta.encode_extract_qkv(x)
    with torch.no_grad(), FlopCounterMode(display=False) as head:
        meta.decoder(type(meta.decoder).prune_enc_head(feats), mode="head",
                     x=qkv["v"])
    return enc.get_total_flops() / 1e12, head.get_total_flops() / 1e12


def backbone_phase(name: str, fam, edt_kernel, cuda_build,
                   profile_path=None) -> dict:
    """The stream of ``vmn_<name>`` (DIM, IndexNet or GCA) at 1088x1920,
    random weights from seed 0 (GCA's spectral-norm u and v then set to
    its weights' leading singular vectors: drawn at random they give
    sigma near 0 and of either sign), as phases 4 and 5 drive FBA's: 4
    frames in f32, then 12 in bf16, each through the kernels (launches
    counted) and through the plain versions; the bf16 plain path also with
    the TPU kernel's rounding of its weights. If the f32 mattes are
    saturated (under LIVE_SHARE of the unknown pixels strictly between 0
    and 255), the weights are calibrated on three frames first. Returns
    the f32 and bf16 launches."""
    from tcvom_tpu_torch.infer.predict import StreamingPredictor
    from tcvom_tpu_torch.models.full_model import TaskConfig, forward_eval
    from tcvom_tpu_torch.models.registry import (build_model,
                                                 calibrate_random_weights,
                                                 converge_spectral_norms)

    frames = make_frames(12)
    cfg = TaskConfig(model="vmn_" + name, agg_window=WINDOW)
    model = build_model(cfg.model, agg_window=WINDOW,
                        generator=torch.Generator().manual_seed(0))
    if name == "gca":
        converge_spectral_norms(model)
    enc_tflop, head_tflop = stream_tflop(model, 3 + cfg.trimap_channels)

    def f32_stream():
        sp32 = StreamingPredictor(model, cfg, fgbg=False, quantize=True)
        cuda_build.LAUNCHES.clear()
        got = run_stream(sp32, frames[:4])
        return sp32, got, dict(cuda_build.LAUNCHES)

    sp32, got, f32_counts = f32_stream()
    share_random = unknown_share(got, frames[:4])
    calibrated = share_random < LIVE_SHARE
    if calibrated:
        imgs, tris = (torch.stack([f[i] for f in frames[:3]], 1).float()
                      for i in (0, 1))
        calibrate_random_weights(
            model, lambda: forward_eval(model, imgs, tris, cfg))
        del sp32, got, imgs, tris
        sp32, got, f32_counts = f32_stream()
    share = unknown_share(got, frames[:4])
    check_mattes(got, frames, f"{name} f32")
    feats = [sp32.encode(*frames[i]) for i in range(3)]
    dec32_ms = host_ms(lambda: sp32.decode(*feats), 10)
    del feats
    want = run_plain_stream(sp32, frames[:4], fam, edt_kernel, cuda_build)
    diff, same = hold_stream(
        f"main_{name}_f32", want, got, launches=f32_counts,
        decode_ms=dec32_ms, unknown_share_random_weights=share_random,
        weights_calibrated=calibrated, unknown_share=share)
    if f32_counts != with_pools({"fam_window": 4}, name, 4, 4):
        fail(f"{name} f32 launch counts {f32_counts}, want 4 decodes (and "
             "DIM's pools and unpools of 4 encodes and 4 decodes)")
    if share < LIVE_SHARE:
        fail(f"{name} f32 mattes saturated: {share:.6f} of the unknown "
             "pixels strictly between 0 and 255")
    if diff > 1 or same < 0.999:
        fail(f"{name} f32 mattes: kernels and plain versions disagree")
    del sp32, got, want

    sp = StreamingPredictor(model, cfg, dtype=torch.bfloat16, fgbg=False,
                            quantize=True)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    outs = run_stream(sp, frames)
    counts = dict(cuda_build.LAUNCHES)
    mem_gib = torch.cuda.max_memory_allocated() / 2**30
    n = len(frames)
    check_mattes(outs, frames, f"{name} bf16")
    if counts != with_pools({"fam_window": n}, name, n, n):
        fail(f"{name} bf16 launch counts {counts}, want {n} decodes (and "
             f"DIM's pools and unpools of {n} encodes and {n} decodes)")
    want = run_plain_stream(sp, frames, fam, edt_kernel, cuda_build)
    with mock.patch.object(fam, "fam_attention", fam_ref_tpu_weights):
        tpu = run_stream(sp, frames)
    hold_stream(f"tpu_rounding_{name}", want, tpu,
                what="plain path with the TPU kernel's bf16 weights")
    diff, same = hold_stream(f"main_{name}_bf16", want, outs,
                             unknown_share=unknown_share(outs, frames),
                             weights_calibrated=calibrated)
    limit = BF16_BACKBONE[name]
    if diff > limit["max_level_diff"] or same < limit["identical_share"]:
        fail(f"{name} bf16 mattes: kernels {diff} levels off plain at most, "
             f"{same:.6f} identical; allowed {limit}")
    del want, tpu, outs

    img, tri = frames[1]
    f_prev, f_cur, f_next = (sp.encode(*frames[i]) for i in range(3))
    enc_ms = host_ms(lambda: sp.encode(img, tri), 10)
    dec_ms = host_ms(lambda: sp.decode(f_prev, f_cur, f_next), 10)
    state = None
    for fr in frames[:2]:
        state, _ = sp.step(state, *fr)

    def one_step():
        nonlocal state
        state, _ = sp.step(state, img, tri)

    step_ms = host_ms(one_step, 10)
    extra = {}
    if name == "gca":
        extra["attention_core_ms"] = gca_core_ms()
    emit(phase=f"main_{name}_bf16", frames=n, launches=counts,
         encode_ms=enc_ms, decode_ms=dec_ms, step_ms=step_ms,
         fps=1e3 / step_ms, max_memory_allocated_gib=mem_gib,
         encode_tflop=enc_tflop, head_tflop=head_tflop,
         step_tflop_per_s=(enc_tflop + head_tflop) / step_ms * 1e3, **extra)
    if profile_path:
        profile_steps(one_step, 2, profile_path, f"profile_{name}_bf16")
    return {"f32": f32_counts, "bf16": counts}


def gca_core_ms() -> float:
    """CUDA-event ms of one call of GCA's attention core at the bf16
    stream's shapes (guidance [1, 64, 68, 120], features [1, 128, 136,
    240], a random unknown mask; two calls an encode)."""
    from tcvom_tpu_torch.ops.gca_attention import guided_attention_core

    g = torch.Generator(device="cuda").manual_seed(0)
    f, alpha = (torch.randn(shape, device="cuda", generator=g).to(
        torch.bfloat16) for shape in ((1, 64, H // 16, W // 16),
                                      (1, 128, H // 8, W // 8)))
    unk = (torch.rand((1, 1, H // 16, W // 16), device="cuda", generator=g)
           > 0.6).to(torch.bfloat16)
    with torch.inference_mode():
        return time_ms(lambda: guided_attention_core(f, alpha, unk), 10)


def random_checkpoint(name: str, tmp):
    """A .pth of ``name`` with random weights from seed 0 (GCA's
    spectral-norm u and v set to its weights' singular vectors, as in
    backbone_phase)."""
    from tcvom_tpu_torch.models.registry import (build_model,
                                                 converge_spectral_norms)
    from tcvom_tpu_torch.utils.checkpoint import save_weights

    model = build_model(name, agg_window=WINDOW,
                        generator=torch.Generator().manual_seed(0))
    if name.endswith("gca"):
        converge_spectral_norms(model)
    path = tmp / f"{name}.pth"
    save_weights(model, str(path))
    return path


def pred_single_phase(name: str, tmp, root, cuda_build):
    """tools/pred_single.py with the single-frame ``name`` (DIM or GCA,
    random weights through a .pth) on pred_vmn's clip: f32, B = 1,
    1088x1920, medium trimaps, the samples read in this process. There is
    no FAM, and neither trimap has an EDT: DIM's pools and unpools (five
    of each a sample) are the only kernels on this path."""
    from tcvom_tpu_torch.tools import pred_single

    ckpt, save = random_checkpoint(name, tmp), tmp / f"pred_single_{name}"
    cuda_build.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = pred_single.main(["--model", name, "--dataset", "vmd", "--data",
                            str(root), "--load", str(ckpt), "--trimap",
                            "medium", "--save", str(save), "--batch", "1",
                            "--image_shape", str(H), str(W),
                            "--n_threads", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda_build.LAUNCHES)
    written = sorted(p.name for p in (save / "clip_b").iterdir())
    emit(phase="pred_single", model=name, samples=4, shape=[1, 3, H, W],
         result=res, seconds=secs, s_per_sample=secs / 4, launches=counts,
         written=len(written))
    if counts != with_pools({}, name, 4, 4):
        fail(f"pred_single {name} launched kernels: {counts}")
    if not all(np.isfinite(v) for v in res.values()):
        fail(f"pred_single {name} results {res}")
    if written != [f"{i:05d}_{k}.png" for i in range(4)
                   for k in ("pred", "tri")]:
        fail(f"pred_single {name} wrote {written}")


ADOBE_HW = (1080, 1440)          # a Composition-1k still's size


def pred_single_adobe_phase(tmp, cuda_build, edt_kernel) -> dict:
    """tools/pred_single.py --model fba --dataset adobe on two stills of
    Composition-1k's size (backgrounds twice as large), FBA at the
    published depth with random weights through a .pth, f32, B = 1,
    medium trimaps, the samples read in this process: at the tool's
    defaults (--val_mode resize --min_shape 800, the 800x800 grid) with
    --vis, and at --val_mode origin (the 2112x2112 grid). Each run
    launches kernel A once a sample (the trimap encoding of the three
    synthesized frames: a [3*2*grid, grid] row pass), writes the PNGs at
    the JAX tool's crops (the still's size cut to the grid) and, with
    --vis, one captioned image a sample. The row pass's input of each run
    is captured from the counted run itself and kernel A held bit-exact
    against its plain version there, and timed. Returns the kernel rows'
    numbers and launches by path."""
    from tcvom_tpu_torch.tools import pred_single
    from tcvom_tpu_torch.tools.make_fake_dataset import make_adobe
    from tcvom_tpu_torch.utils import imageio

    t_phase = time.perf_counter()
    root, n = tmp / "adobe_eval", 2
    make_adobe(str(root), n=n, hw=ADOBE_HW, seed=3)
    ogs = [(ADOBE_HW[0] + 8 * i, ADOBE_HW[1] + 4 * i) for i in range(n)]
    ckpt = random_checkpoint("fba", tmp)
    setup_s = time.perf_counter() - t_phase
    kernel_row_pass = edt_kernel.edt_row_pass
    res = {}
    for mode, grid, vis in (("resize", 800, True), ("origin", 2112, False)):
        save, seen = tmp / f"pred_single_adobe_{mode}", []

        def record(g2, t):
            if not seen:
                seen.append((g2.clone(), t))
            return kernel_row_pass(g2, t)

        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with mock.patch.object(edt_kernel, "edt_row_pass", record):
            out = pred_single.main(
                ["--model", "fba", "--dataset", "adobe", "--data", str(root),
                 "--load", str(ckpt), "--trimap", "medium", "--save",
                 str(save), "--val_mode", mode, "--batch", "1",
                 "--n_threads", "0"] + (["--vis"] if vis else []))
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(cuda_build.LAUNCHES)
        crops = [(min(h, grid), min(w, grid)) for h, w in ogs]
        shapes = {f"{i:05d}_{k}": imageio.imread(
            str(save / f"{i:05d}_{k}.png"), imageio.IMREAD_UNCHANGED).shape
            for i in range(n) for k in ("pred", "tri")}
        vis_shapes = ([imageio.imread(str(save / "vis" / f"{i:05d}.png")
                                      ).shape for i in range(n)]
                      if vis else [])
        path = f"pred_single_adobe_{mode}"
        emit(phase=path, samples=n, grid=[grid, grid], result=out,
             seconds=secs, s_per_sample=secs / n, launches=counts,
             written=shapes, vis=vis_shapes,
             row_pass_input=list(seen[0][0].shape) if seen else None)
        if counts != with_norms({"edt_row": n}, n * FBA_NORMS):
            fail(f"{path} launch counts {counts}, want {n} edt_row and "
                 f"{FBA_NORMS} a sample of each GroupNorm kernel")
        if not all(np.isfinite(v) for v in out.values()):
            fail(f"{path} results {out}")
        if shapes != {f"{i:05d}_{k}": crops[i] for i in range(n)
                      for k in ("pred", "tri")}:
            fail(f"{path} wrote {shapes}, want the crops {crops}")
        if vis and vis_shapes != [(h + 100, 2 * w, 3) for h, w in crops]:
            fail(f"{path} vis images {vis_shapes}")
        if list(seen[0][0].shape) != [3 * 2 * grid, grid]:
            fail(f"{path} row pass input {list(seen[0][0].shape)}")
        res[path] = dict(hold_edt(edt_kernel, *seen[0], timed=True,
                                  path=path), launches=counts["edt_row"])
        del seen
    emit(phase="pred_single_adobe", setup_s=setup_s,
         seconds=time.perf_counter() - t_phase)
    return res


def live_share(folder) -> float:
    """The share of the pixels of a sweep's ``*_pred.png`` mattes that lie
    strictly between 0 and 255."""
    from tcvom_tpu_torch.utils.imageio import IMREAD_GRAYSCALE, imread

    a = np.stack([imread(str(p), IMREAD_GRAYSCALE)
                  for p in sorted(folder.glob("clip_b/*_pred.png"))])
    return float(((a > 0) & (a < 255)).mean())


def pred_vmn_backbone_phase(name: str, tmp, root, cuda_build):
    """tools/pred_vmn.py with ``vmn_<name>`` (IndexNet or GCA, random
    weights through a .pth) on the same clip, the samples read in this
    process (the spawned loader's start is timed in the FBA sweep); at
    least LIVE_SHARE of the pred PNGs' pixels strictly between 0 and 255.
    Returns the launches and the sweep as the space phase's reference:
    (its .pth, its folder, its seconds by phase and peak)."""
    from tcvom_tpu_torch.tools import pred_vmn

    ckpt = random_checkpoint("vmn_" + name, tmp)
    save = tmp / f"pred_vmn_{name}"
    cuda_build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0, sweep = time.perf_counter(), {}
    losses = pred_vmn.main(["--model", name, "--data", str(root),
                            "--load", str(ckpt), "--trimap", "medium",
                            "--save", str(save), "--agg_window", str(WINDOW),
                            "--batch", "1", "--image_shape", str(H), str(W),
                            "--n_threads", "0"], sweep)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sweep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(cuda_build.LAUNCHES)
    written = sorted(p.name for p in (save / "clip_b").iterdir())
    share = live_share(save)
    emit(phase=f"pred_vmn_{name}", samples=4, shape=[1, 3, H, W],
         launches=counts, losses=losses, sweep_s=secs,
         s_per_sample=secs / 4, sweep_phases_s=sweep, written=len(written),
         live_share=share, max_memory_allocated_gib=sweep["peak_gib"])
    if counts != {"fam_window_logits": 4}:
        fail(f"pred_vmn {name} launch counts {counts}, want 4")
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"pred_vmn {name} losses {losses}")
    if written != [f"{i:05d}_{k}.png" for i in range(4)
                   for k in ("pred", "tri")]:
        fail(f"pred_vmn {name} wrote {written}")
    if share < LIVE_SHARE:
        fail(f"pred_vmn {name}: {share} of the mattes' pixels live, under "
             f"{LIVE_SHARE}")
    return counts, (ckpt, save, sweep)


def probe_modules() -> dict:
    """The version of each module the port takes from outside its own
    requirements, None where it does not import: OpenCV (PNG and JPEG
    codecs, the training augmentations, the DIM warps) and PyYAML (the
    training configs)."""
    import importlib

    found = {}
    for name in ("cv2", "yaml"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = None
    return found


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("--profile", metavar="FILE",
                    help="profile two bf16 stream steps of each backbone, "
                         "one pred_vmn evaluation step and two train steps; "
                         "write the tables to FILE")
    ap.add_argument("--tool", choices=["train", "pred_vmn"],
                    help="(the DDP phases' runs) run tcvom_tpu_torch.tools."
                         "TOOL with the other arguments instead; train "
                         "validates from its first epoch")
    ap.add_argument("--launches", metavar="DIR", nargs="+",
                    help="with --tool: write this rank's kernel launches "
                         "to DIR/rank_<RANK>.json (and pred_vmn's stats "
                         "to DIR/rank_<RANK>_stats.json), one DIR for each "
                         "run (pred_vmn takes several, their arguments "
                         "separated by --then)")
    ap.add_argument("--no_tf32", action="store_true",
                    help="with --tool: no TF32 in cuDNN or cuBLAS, as this "
                         "script's own runs")
    args, rest = ap.parse_known_args()
    if args.tool:
        tool_rank(args.tool, args.launches, rest, tf32=not args.no_tf32)
        return
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    t_start = time.perf_counter()
    adopted = adopt_orphans()
    atexit.register(stop_children)
    # cuBLAS's deterministic mode (the train phases' held steps) needs its
    # workspace fixed before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    emit(phase="device", name=kind, count=count, torch=torch.__version__,
         cuda=torch.version.cuda, probes=probe_modules())
    print(smi, flush=True)

    from tcvom_tpu_torch.infer.predict import StreamingPredictor
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.models.registry import build_model
    from tcvom_tpu_torch.models.layers import GroupNorm
    from tcvom_tpu_torch.ops import (argmax_pool_kernel, cuda_build, distance,
                                     edt_kernel, fam, fam_kernel,
                                     group_norm_kernel)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build(["edt_row", "fam_window", "group_norm",
                             "argmax_pool"])
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_source={n: log["seconds"] for n, log in logs.items()})
    for name, log in logs.items():
        for line in log["output"].splitlines():
            if "spill" in line or ("ptxas info" in line and (
                    "Used" in line or "entry function" in line)):
                print(f"{name}: {line.strip()}", flush=True)
        emit(phase="sass", source=name,
             instructions=sass_counts(cuda_build.library_path(name)))

    # -- 3. kernels against their plain versions -------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = make_frames(12)
    edt_res = check_edt(edt_kernel, distance, frames[0][1])
    fam_res = check_fam(fam, fam_kernel)
    gn_res = check_group_norm(group_norm_kernel)
    pool_res = check_argmax_pool(argmax_pool_kernel)

    # -- 4. main path, f32, kernels vs plain -----------------------------------
    cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW)
    model = build_model("vmn_fba", agg_window=WINDOW,
                        generator=torch.Generator().manual_seed(0))
    norms = sum(isinstance(m, GroupNorm) for m in model.modules())
    if norms != FBA_NORMS:
        fail(f"vmn_fba has {norms} GroupNorms, FBA_NORMS says {FBA_NORMS}")
    sp32 = StreamingPredictor(model, cfg, fgbg=False, quantize=True)
    cuda_build.LAUNCHES.clear()
    got = run_stream(sp32, frames[:4])
    f32_counts = dict(cuda_build.LAUNCHES)
    feats = [sp32.encode(*frames[i]) for i in range(3)]
    dec32_ms = host_ms(lambda: sp32.decode(*feats), 10)
    del feats

    want = run_plain_stream(sp32, frames[:4], fam, edt_kernel, cuda_build)
    diff, same = hold_stream("main_f32", want, got, launches=f32_counts,
                             decode_ms=dec32_ms)
    if f32_counts != with_norms({"edt_row": 4, "fam_window": 4},
                                4 * FBA_NORMS):
        fail(f"f32 launch counts {f32_counts}, want 4 encodes and 4 decodes")
    if diff > 1 or same < 0.999:
        fail("f32 mattes: kernels and plain versions disagree")
    del sp32, got, want

    # -- 5. main path, bf16, as users run it -----------------------------------
    sp = StreamingPredictor(model, cfg, dtype=torch.bfloat16, fgbg=False,
                            quantize=True)
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    outs = run_stream(sp, frames)
    counts = dict(cuda_build.LAUNCHES)
    n = len(frames)
    check_mattes(outs, frames, "bf16")
    if counts != with_norms({"edt_row": n, "fam_window": n}, n * FBA_NORMS):
        fail(f"bf16 launch counts {counts}, want {n} encodes and {n} decodes")
    # the FAM and EDT kernels against their plain versions, the GroupNorm
    # kernels in both runs: FBA's random weights amplify any change of
    # GroupNorm's rounding (the kernels round once where the plain ops in
    # bf16 round twice) into whole flipped pixels (PERF.md, kernel E);
    # GroupNorm is held by the f32 stream above, check_group_norm and its
    # card tests
    want = run_plain_stream(sp, frames, fam, edt_kernel, cuda_build,
                            group_norm=False)
    diff, same = hold_stream("main_bf16", want, outs)
    if diff > BF16_STREAM["max_level_diff"] or \
            same < BF16_STREAM["identical_share"]:
        fail(f"bf16 mattes: kernels {diff} levels off plain at most, "
             f"{same:.6f} identical; allowed {BF16_STREAM}")
    del want

    img, tri = frames[1]
    f_prev, f_cur, f_next = (sp.encode(*frames[i]) for i in range(3))
    enc_ms = host_ms(lambda: sp.encode(img, tri), 10)
    dec_ms = host_ms(lambda: sp.decode(f_prev, f_cur, f_next), 10)
    state = None
    for fr in frames[:2]:
        state, _ = sp.step(state, *fr)

    def one_step():
        nonlocal state
        state, _ = sp.step(state, img, tri)

    step_ms = host_ms(one_step, 10)
    emit(phase="main_bf16", frames=n, mattes=len(outs), launches=counts,
         encode_ms=enc_ms, decode_ms=dec_ms, step_ms=step_ms,
         fps=1e3 / step_ms,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)

    if args.profile:
        open(args.profile, "w").close()
        profile_steps(one_step, 2, args.profile, "profile_bf16")
    del sp, frames, state, f_prev, f_cur, f_next
    torch.cuda.empty_cache()

    # -- 6. the evaluation tools: pred_test (bf16), pred_vmn (f32), calc_metric
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    # the tools' files, kept for phase 11 (removed at exit in any case)
    tmpdir = tempfile.TemporaryDirectory(dir=build)
    tmp = Path(tmpdir.name)
    pt_counts = pred_test_phase(model, tmp, step_ms, fam, edt_kernel,
                                cuda_build)
    vmn_counts, root, save, vmn_sweep = pred_vmn_phase(model, tmp,
                                                       cuda_build,
                                                       args.profile)
    del model
    torch.cuda.empty_cache()
    calc_metric_phase(root, save)

    # -- 7. training and pred_vmn kernels against their plain versions ---------
    logits_res = check_fam_logits(fam, fam_kernel)
    edt_train_res = check_edt_train(edt_kernel)

    # -- 8. the video trainer, f32, full width and depth -------------------------
    train_counts, val_counts = train_phase(fam, edt_kernel, cuda_build,
                                           args.profile)
    torch.cuda.empty_cache()

    # -- 9. the FAM kernels at IndexNet's and GCA's widths ------------------------
    c32_res = check_fam_width(fam, fam_kernel, 32, seed=9)
    c128_res = check_fam_width(fam, fam_kernel, 128, seed=10)

    # -- 10. the DIM, IndexNet and GCA streams, f32 and bf16 ----------------------
    streams = {}
    for name in ("dim", "index", "gca"):
        streams[name] = backbone_phase(name, fam, edt_kernel, cuda_build,
                                       args.profile)
        torch.cuda.empty_cache()

    # -- 11. pred_single (DIM, GCA) and pred_vmn (IndexNet, GCA) on the clip ------
    vmn_backbone_counts, space_refs = {}, {}
    for name in ("dim", "gca"):
        pred_single_phase(name, tmp, root, cuda_build)
    adobe_res = pred_single_adobe_phase(tmp, cuda_build, edt_kernel)
    torch.cuda.empty_cache()
    for name in ("index", "gca"):
        vmn_backbone_counts[name], space_refs[name] = \
            pred_vmn_backbone_phase(name, tmp, root, cuda_build)

    # -- 12. the logits kernel at the other backbones' training widths -------
    train_width_res = check_fam_train_widths(fam, fam_kernel)
    torch.cuda.empty_cache()

    # -- 13. the DIM, IndexNet and GCA video trainers, f32, full width ------
    trains = {}
    for name in ("dim", "index", "gca"):
        trains[name] = train_backbone_phase(name, fam, edt_kernel, cuda_build,
                                            args.profile)
        torch.cuda.empty_cache()

    # -- 14. the training CLI in subprocesses: run, resume, frozen backbone ---
    train_cli_phase(tmp)

    # -- 15. data-parallel training and pred_vmn under torch.distributed.run --
    ddp_counts = train_ddp_phases(tmp)
    ddp_counts["pred_vmn_ddp"] = pred_vmn_ddp_phase(tmp, root)
    band_res = {c: check_fam_band(fam, fam_kernel, c) for c in BAND_WIDTHS}
    space_counts = pred_vmn_space_phase(
        tmp, root, dict(space_refs, fba=(tmp / "vmn_fba.pth", save,
                                         vmn_sweep)))

    # -- 16. TRAIN.BF16 and --remat of each video trainer, and the tool -----
    bf16_counts, remat_counts = {}, {}
    for name in ("fba", "dim", "index", "gca"):
        bf16_counts[name] = train_bf16_phase(name, cuda_build, fam_kernel)
        remat_counts[name] = train_remat_phase(name, cuda_build)
        torch.cuda.empty_cache()
    cli16_counts = train_cli_bf16_remat_phase(tmp)
    tmpdir.cleanup()

    # every row: the launches are its own path's (counts set to 0 just
    # before the path, read just after), the rest measured above
    edt = dict(name="edt_row", route="cuda",
               source="tcvom_tpu_torch/csrc/edt_row.cu",
               replaces="tcvom_tpu/ops/edt_pallas.py:39", library_ms=None)
    famk = dict(route="cuda", source="tcvom_tpu_torch/csrc/fam_window.cu",
                library_ms=None)
    fam_b = dict(famk, name="fam_window",
                 replaces="tcvom_tpu/ops/fam_pallas.py:190")
    logits_c = dict(famk, name="fam_window_logits",
                    replaces="tcvom_tpu/ops/fam_pallas.py:38")
    gn = dict(name="group_norm", route="cuda",
              source="tcvom_tpu_torch/csrc/group_norm.cu",
              replaces="none (XLA's GroupNorm, tcvom_tpu/models/layers.py)")
    kernels = [
        dict(gn, path=path, launches=n["group_norm_stats"], **gn_res[shape])
        for path, n in (("stream_bf16", counts), ("pred_test", pt_counts))
        for shape in GN_SHAPES] + [
        dict(edt, path="stream_bf16", launches=counts["edt_row"], **edt_res),
        dict(edt, path="pred_test", launches=pt_counts["edt_row"], **edt_res),
        dict(edt, path="train", launches=train_counts["edt_row"],
             **edt_train_res["train"]),
        dict(edt, path="pred_vmn", launches=vmn_counts["edt_row"],
             **edt_train_res["pred_vmn"]),
        dict(fam_b, path="stream_bf16", launches=counts["fam_window"],
             **fam_res[torch.bfloat16]),
        dict(fam_b, path="pred_test", launches=pt_counts["fam_window"],
             **fam_res[torch.bfloat16]),
        dict(fam_b, path="stream_f32", launches=f32_counts["fam_window"],
             **fam_res[torch.float32]),
        dict(logits_c, path="train",
             launches=train_counts["fam_window_logits"],
             **logits_res[(6, 64, 64, 256)]),
        dict(logits_c, path="val", replaces="tcvom_tpu/ops/fam_pallas.py:97",
             launches=val_counts["fam_window_logits"],
             **logits_res[(12, 68, 120, 256)]),
        dict(logits_c, path="pred_vmn", replaces="tcvom_tpu/ops/fam_pallas.py:97",
             launches=vmn_counts["fam_window_logits"],
             **logits_res[(2, 136, 240, 256)]),
        dict(fam_b, path="stream_dim_bf16",
             launches=streams["dim"]["bf16"]["fam_window"],
             **fam_res[torch.bfloat16]),
        dict(fam_b, path="stream_dim_f32",
             launches=streams["dim"]["f32"]["fam_window"],
             **fam_res[torch.float32]),
        dict(fam_b, path="stream_index_bf16",
             launches=streams["index"]["bf16"]["fam_window"],
             **c32_res[torch.bfloat16]),
        dict(fam_b, path="stream_index_f32",
             launches=streams["index"]["f32"]["fam_window"],
             **c32_res[torch.float32]),
        dict(logits_c, path="pred_vmn_index",
             replaces="tcvom_tpu/ops/fam_pallas.py:97",
             launches=vmn_backbone_counts["index"]["fam_window_logits"],
             **c32_res["logits"]),
        dict(fam_b, path="stream_gca_bf16",
             launches=streams["gca"]["bf16"]["fam_window"],
             **c128_res[torch.bfloat16]),
        dict(fam_b, path="stream_gca_f32",
             launches=streams["gca"]["f32"]["fam_window"],
             **c128_res[torch.float32]),
        dict(logits_c, path="pred_vmn_gca",
             replaces="tcvom_tpu/ops/fam_pallas.py:97",
             launches=vmn_backbone_counts["gca"]["fam_window_logits"],
             **c128_res["logits"]),
    ]
    for name, train_shape, val_res in (
            ("dim", (24, 64, 64, 256), logits_res[(12, 68, 120, 256)]),
            ("index", (24, 64, 64, 32), train_width_res[(12, 68, 120, 32)]),
            ("gca", (36, 64, 64, 128), train_width_res[(12, 68, 120, 128)])):
        train_counts_, val_counts_ = trains[name]
        kernels += [
            dict(logits_c, path=f"train_{name}",
                 launches=train_counts_["fam_window_logits"],
                 **train_width_res[train_shape]),
            dict(logits_c, path=f"val_{name}",
                 replaces="tcvom_tpu/ops/fam_pallas.py:97",
                 launches=val_counts_["fam_window_logits"], **val_res)]
    # the DDP training runs' launches are rank 0's process's, from its
    # train_stats.json (the steps and the first step's image grids; the
    # validation apart); pred_vmn_ddp's are both ranks'
    val_d = "tcvom_tpu/ops/fam_pallas.py:97"
    kernels += [
        dict(edt, path="train_ddp_fba",
             launches=ddp_counts["train_ddp_fba"].get("edt_row", 0),
             **edt_train_res["train"]),
        dict(logits_c, path="train_ddp_fba",
             launches=ddp_counts["train_ddp_fba"].get("fam_window_logits",
                                                      0),
             **logits_res[(6, 64, 64, 256)]),
        dict(edt, path="val_ddp_fba",
             launches=ddp_counts["val_ddp_fba"].get("edt_row", 0),
             **edt_train_res["val_ddp"]),
        dict(logits_c, path="val_ddp_fba", replaces=val_d,
             launches=ddp_counts["val_ddp_fba"].get("fam_window_logits", 0),
             **logits_res[(2, 68, 120, 256)]),
        dict(logits_c, path="train_ddp_gca2",
             launches=ddp_counts["train_ddp_gca2"].get("fam_window_logits",
                                                       0),
             **train_width_res[(36, 64, 64, 128)]),
        dict(edt, path="pred_vmn_ddp",
             launches=ddp_counts["pred_vmn_ddp"]["edt_row"],
             **edt_train_res["pred_vmn"]),
        dict(logits_c, path="pred_vmn_ddp", replaces=val_d,
             launches=ddp_counts["pred_vmn_ddp"]["fam_window_logits"],
             **logits_res[(2, 136, 240, 256)])]
    # pred_vmn --space 2: both ranks' launches; kernel A on the whole
    # frame on each rank, kernel D on each rank's band and its halo
    kernels += [
        dict(edt, path="pred_vmn_space_fba",
             launches=space_counts["fba"]["edt_row"],
             **edt_train_res["pred_vmn"])] + [
        dict(logits_c, path=f"pred_vmn_space_{name}", replaces=val_d,
             launches=space_counts[name]["fam_window_logits"],
             **band_res[c])
        for name, c in (("fba", 256), ("dim", 256), ("index", 32),
                        ("gca", 128))]
    kernels += [dict(edt, path=path, **r) for path, r in adobe_res.items()]
    pool = dict(name="argmax_pool", route="cuda",
                source="tcvom_tpu_torch/csrc/argmax_pool.cu",
                replaces="none (XLA's fusion of tcvom_tpu/ops/image.py's "
                         "max_pool_argmax_2x2 and max_unpool_2x2)",
                launches=streams["dim"]["bf16"]["argmax_pool_fwd"])
    kernels += [dict(pool, path="stream_dim_bf16", **r)
                for (batch, _), r in sorted(pool_res.items()) if batch == 1]
    train_res = {"fba": logits_res[(6, 64, 64, 256)],
                 "dim": train_width_res[(24, 64, 64, 256)],
                 "index": train_width_res[(24, 64, 64, 32)],
                 "gca": train_width_res[(36, 64, 64, 128)]}
    for name, res in train_res.items():
        for path, n in ((f"train_{name}_bf16", bf16_counts[name]),
                        (f"train_{name}_remat", remat_counts[name])):
            kernels.append(dict(logits_c, path=path,
                                launches=n.get("fam_window_logits", 0),
                                **res))
            if name == "fba":
                kernels.append(dict(edt, path=path,
                                    launches=n.get("edt_row", 0),
                                    **edt_train_res["train"]))
    kernels.append(dict(logits_c, path="train_cli_bf16_remat",
                        launches=cli16_counts.get("fam_window_logits", 0),
                        **train_res["index"]))
    emit(phase="wall", seconds=time.perf_counter() - t_start)
    emit(phase="stop", subreaper=adopted, **stop_children())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


def profile_steps(step, steps: int, path: str, phase: str):
    """Device time by kernel over ``steps`` calls of ``step``, and the
    device's busy share of the window's wall time; the table is appended
    to ``path`` under a ``== phase ==`` line."""
    import os
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the program's ``tcvom.*`` ranges can also be listed as device-side
    # annotations spanning the kernels they enclose: left out, as
    # ``key_averages().table`` leaves them out of its own total
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("tcvom.")]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"== {phase}, {steps} steps ==\n{table}\n")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    emit(phase=phase, steps=steps, wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms,
         top=[[e.key[:80], e.self_device_time_total / (steps * 1e3)]
              for e in top])


if __name__ == "__main__":
    main()
