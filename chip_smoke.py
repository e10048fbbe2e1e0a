#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tcvom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]

From the repo root, on a machine with a CUDA card and the CUDA toolkit:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: both CUDA kernels from tcvom_tpu_torch/csrc, with ptxas's
   register and shared-memory report and each kernel's SASS instruction
   count;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (EDT row pass bit-exact; both FAM entries, out and
   logits, f32 to 1e-5, bf16 to 2e-2), with CUDA-event times and the
   card's bound for the same work;
4. the main path in f32 at full width (vmn_fba, 1088x1920, window 7,
   random weights from a seed): once through the kernels, once with the
   plain versions substituted; the uint8 mattes agree within one level;
   the decode's time;
5. the main path in bf16, as users run it: the launch counts must equal
   the encodes (EDT) and decodes (FAM); known trimap pixels pasted
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
   fam_window_logits launch per sample, finite losses, the PNGs); then
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
   memory.

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
# share of the unknown pixels (trimap 128) whose matte must lie strictly
# between 0 and 255 before a comparison of mattes says something
LIVE_SHARE = 0.01
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


def emit(**kw):
    print(json.dumps(kw), flush=True)


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


def plain_kernels(fam, edt_kernel):
    """A context in which both kernels' plain versions stand in for them."""
    import contextlib

    def plain_fam(q, k, mask, window, need_logits=False):
        out, lg = fam.fam_attention_ref(q, k, mask, window)
        return out, (lg if need_logits else None)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fam, "fam_attention", plain_fam))
    stack.enter_context(mock.patch.object(edt_kernel, "edt_row_pass",
                                          edt_kernel.edt_row_pass_ref))
    return stack


def run_plain_stream(sp, frames, fam, edt_kernel, cuda_build):
    """The stream through the plain versions of both kernels; it must
    launch none."""
    cuda_build.LAUNCHES.clear()
    with plain_kernels(fam, edt_kernel):
        outs = run_stream(sp, frames)
    if sum(cuda_build.LAUNCHES.values()):
        fail(f"a plain run launched kernels: {dict(cuda_build.LAUNCHES)}")
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
    if counts != {"edt_row": n, "fam_window": n}:
        fail(f"pred_test launch counts {counts}, want {n} of each")
    for i, matte in enumerate(got):
        tri = imageio.imread(f"{src}/{i:05d}_trimap.png",
                             imageio.IMREAD_GRAYSCALE)
        known = (tri == 0) | (tri == 255)
        if matte.shape != hw or matte.dtype != np.uint8:
            fail(f"pred_test matte {matte.shape} {matte.dtype}")
        if not np.array_equal(matte[known], tri[known]):
            fail(f"pred_test matte {i}: known pixels differ from the trimap")
    with plain_kernels(fam, edt_kernel):
        cuda_build.LAUNCHES.clear()
        _, _, want = run("plain")
        if sum(cuda_build.LAUNCHES.values()):
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
    the tree, the predictions' folder)."""
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
    t0, sweep = time.perf_counter(), {}
    losses = pred_vmn.main(["--model", "fba", "--data", str(root), "--load",
                            str(ckpt), "--trimap", "medium", "--save",
                            str(save), "--agg_window", str(WINDOW),
                            "--batch", "1", "--n_threads", "2"], sweep)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
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
    if counts != {"edt_row": 4, "fam_window_logits": 4}:
        fail(f"pred_vmn launch counts {counts}, want 4 of each")
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"pred_vmn losses {losses}")
    if written != [f"{i:05d}_{k}.png" for i in range(4)
                   for k in ("pred", "tri")]:
        fail(f"pred_vmn wrote {written}")
    return counts, root, save


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
    if val_counts != {"edt_row": 1, "fam_window_logits": 1}:
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
    trainer = MattingTrainer(task, "vmd", optimizer=tcfg.OPTIMIZER,
                             lr_strategy=tcfg.LR_STRATEGY,
                             base_lr=tcfg.BASE_LR,
                             weight_decay=tcfg.WEIGHT_DECAY, total_iters=30)
    batch = make_clip(b, 5, h, w, seed=5)
    radius = FM.draw_radius(b, torch.Generator().manual_seed(3))

    def fresh(weights=None):
        state = trainer.init_state(torch.Generator().manual_seed(0))
        if weights is not None:
            state.model.load_state_dict(weights)
        return state

    state = fresh()
    if name == "gca":
        converge_spectral_norms(state.model)
    if name == "dim":
        calibrate_random_weights(state.model, lambda: FM.forward_vmd(
            state.model, batch, task, radius))
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    del state

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
    if val_counts != {"fam_window_logits": 1}:
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


def gca_b12_steps(tree, ckpt, jitter: float = 0.0):
    """``tools.train``'s first step of GCA_CFG with SGD at B = 12 on
    ``tree``, in this process, as the command makes it (the config, the
    seed's weights and radius generator, ``ckpt`` loaded, the sampler's
    first batch, deterministic algorithms, a fresh process's TF32
    settings), with the batch's fg and bg
    jittered by relative ``jitter``; then a second step on the same
    batch, timed. Returns (the first step's loss, the weights and
    buffers after it, the second step's ms, the peak memory in GiB)."""
    from types import SimpleNamespace

    from tcvom_tpu_torch.config import load_config
    from tcvom_tpu_torch.data.loader import make_loader
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.tools import train as T
    from tcvom_tpu_torch.train.trainer import MattingTrainer
    from tcvom_tpu_torch.utils.checkpoint import load_weights

    cfg = load_config(str(ROOT / "cfgs" / GCA_CFG), [
        "DATASET.PATH", str(tree), "TRAIN.OPTIMIZER", "sgd",
        "TRAIN.BATCH_SIZE_PER_GPU", "12", "TRAIN.TOTAL_STEPS", "1"])
    seed = cfg.SYSTEM.RANDOM_SEED
    data, _ = T._datasets(cfg, SimpleNamespace(
        dataset="vmd", driver="vmd", sample_length=None), seed)
    loader = make_loader(data, 12, shuffle=True, seed=seed, drop_last=True)
    batch = T._on(next(iter(loader)), torch.device("cuda"))
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
        total_iters=cfg.TRAIN.TOTAL_STEPS * len(loader))
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

    def losses(folder):
        return {k: float(v) for k, v in (
            line.split(": ") for line in
            (folder / "loss.log").read_text().splitlines() if line)}

    got, want = losses(out), losses(save)
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


def tool_rank(tool: str, counts_dir: str | None, argv: list) -> None:
    """``--tool``: ``tcvom_tpu_torch.tools.<tool>.main(argv)`` in this
    process (a rank, under ``torch.distributed.run``), from zero launch
    counts; ``tools.train`` validating from its first epoch. With
    ``counts_dir``, the process's kernel launches then go to
    ``<counts_dir>/rank_<RANK>.json``."""
    import importlib

    from tcvom_tpu_torch.ops import cuda_build

    mod = importlib.import_module(f"tcvom_tpu_torch.tools.{tool}")
    if tool == "train":
        mod.VAL_FROM_EPOCH = 0
    cuda_build.LAUNCHES.clear()
    mod.main(argv)
    if counts_dir:
        os.makedirs(counts_dir, exist_ok=True)
        Path(counts_dir, f"rank_{os.environ.get('RANK', '0')}.json"
             ).write_text(json.dumps(dict(cuda_build.LAUNCHES)))


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
    if f32_counts != {"fam_window": 4}:
        fail(f"{name} f32 launch counts {f32_counts}, want 4 decodes")
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
    if counts != {"fam_window": n}:
        fail(f"{name} bf16 launch counts {counts}, want {n} decodes")
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
    1088x1920, medium trimaps, the samples read in this process. No kernel
    is on this path: there is no FAM, and neither trimap has an EDT."""
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
    if counts:
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
        if counts != {"edt_row": n}:
            fail(f"{path} launch counts {counts}, want {n} edt_row")
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


def pred_vmn_backbone_phase(name: str, tmp, root, cuda_build):
    """tools/pred_vmn.py with ``vmn_<name>`` (IndexNet or GCA, random
    weights through a .pth) on the same clip, the samples read in this
    process (the spawned loader's start is timed in the FBA sweep).
    Returns the launches."""
    from tcvom_tpu_torch.tools import pred_vmn

    ckpt = random_checkpoint("vmn_" + name, tmp)
    save = tmp / f"pred_vmn_{name}"
    cuda_build.LAUNCHES.clear()
    t0, sweep = time.perf_counter(), {}
    losses = pred_vmn.main(["--model", name, "--data", str(root),
                            "--load", str(ckpt), "--trimap", "medium",
                            "--save", str(save), "--agg_window", str(WINDOW),
                            "--batch", "1", "--image_shape", str(H), str(W),
                            "--n_threads", "0"], sweep)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda_build.LAUNCHES)
    written = sorted(p.name for p in (save / "clip_b").iterdir())
    emit(phase=f"pred_vmn_{name}", samples=4, shape=[1, 3, H, W],
         launches=counts, losses=losses, sweep_s=secs,
         s_per_sample=secs / 4, sweep_phases_s=sweep, written=len(written),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    if counts != {"fam_window_logits": 4}:
        fail(f"pred_vmn {name} launch counts {counts}, want 4")
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"pred_vmn {name} losses {losses}")
    if written != [f"{i:05d}_{k}.png" for i in range(4)
                   for k in ("pred", "tri")]:
        fail(f"pred_vmn {name} wrote {written}")
    return counts


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
    ap.add_argument("--launches", metavar="DIR",
                    help="with --tool: write this rank's kernel launches "
                         "to DIR/rank_<RANK>.json")
    args, rest = ap.parse_known_args()
    if args.tool:
        tool_rank(args.tool, args.launches, rest)
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
    from tcvom_tpu_torch.ops import (cuda_build, distance, edt_kernel, fam,
                                     fam_kernel)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build(["edt_row", "fam_window"])
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

    # -- 4. main path, f32, kernels vs plain -----------------------------------
    cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW)
    model = build_model("vmn_fba", agg_window=WINDOW,
                        generator=torch.Generator().manual_seed(0))
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
    if f32_counts != {"edt_row": 4, "fam_window": 4}:
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
    if counts != {"edt_row": n, "fam_window": n}:
        fail(f"bf16 launch counts {counts}, want {n} encodes and {n} decodes")
    want = run_plain_stream(sp, frames, fam, edt_kernel, cuda_build)
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
    vmn_counts, root, save = pred_vmn_phase(model, tmp, cuda_build,
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
    vmn_backbone_counts = {}
    for name in ("dim", "gca"):
        pred_single_phase(name, tmp, root, cuda_build)
    adobe_res = pred_single_adobe_phase(tmp, cuda_build, edt_kernel)
    torch.cuda.empty_cache()
    for name in ("index", "gca"):
        torch.cuda.reset_peak_memory_stats()
        vmn_backbone_counts[name] = pred_vmn_backbone_phase(name, tmp, root,
                                                            cuda_build)

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
    kernels = [
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
    kernels += [dict(edt, path=path, **r) for path, r in adobe_res.items()]
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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
