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
6. train_kernels: both FAM entries against the plain version at the
   training path's shapes (f32 to 1e-5, bf16 to 2e-2), the autograd
   Function's dq, dk against the plain version's autograd, and its times;
   the EDT row pass bit-exact at the inputs make_trimap gives it in the
   train and validation steps, with its times at the train step's;
7. train_f32: the video trainer at full width and depth (vmn_fba, B=1,
   S=5, 512x512, Adam, poly lr 1e-4, weight decay 1e-4, synthetic seeded
   clips): one step through the kernels against one through the plain
   versions (losses, gradients, launch counts), five more steps (finite
   losses, ms, peak memory) and one validation step (B=6, S=3, 544x960).

The line before the last lists every kernel row (name, route, source,
the TPU kernel it replaces, launches on its path, error, ms, plain ms,
bound); the last line is ``{"ok": true, "device": {...}}``; any failure
exits non-zero before it. ``--profile FILE`` adds torch.profiler
breakdowns of two bf16 stream steps and two train steps, their tables
written to FILE.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import unittest.mock as mock

import numpy as np
import torch

H, W, WINDOW = 1088, 1920, 7
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


def run_plain_stream(sp, frames, fam, edt_kernel, cuda_build):
    """The stream through the plain versions of both kernels; it must
    launch none."""
    def plain_fam(q, k, mask, window, need_logits=False):
        return fam.fam_attention_ref(q, k, mask, window)[0], None

    cuda_build.LAUNCHES.clear()
    with mock.patch.object(fam, "fam_attention", plain_fam), \
            mock.patch.object(edt_kernel, "edt_row_pass",
                              edt_kernel.edt_row_pass_ref):
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
    """Kernel A at the inputs make_trimap gives it on the training path:
    the column pass of the train batch's bg/fg planes ([B*S*2*512, 512]),
    timed, and of the validation batch's ([B*S*2*544, 960]), captured
    from preprocess with the plain row pass standing in. Returns the
    train shape's times."""
    from tcvom_tpu_torch.models.full_model import (TaskConfig, draw_radius,
                                                   preprocess)

    cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW)
    res = None
    for b, s, h, w, seed, path in ((1, 5, 512, 512, 5, "train"),
                                   (6, 3, 544, 960, 6, "val")):
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
        res = hold_edt(edt_kernel, *seen[0], timed=path == "train",
                       path=path) or res
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
    validation step's (12 at 68x120), timed, and a narrow shape in f32 and
    bf16, the inference entry held at the same inputs; then the autograd
    Function's dq, dk against the plain version's autograd at the training
    shape, with random d_out and d_logits. Returns the times at the
    training and validation shapes, by shape."""
    rng = np.random.RandomState(4)
    res = {}
    for shape, window, dtype in (((6, 64, 64, 256), WINDOW, torch.float32),
                                 ((12, 68, 120, 256), WINDOW, torch.float32),
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

    def plain_fam(q, k, mask, window, need_logits=False):
        out, lg = fam.fam_attention_ref(q, k, mask, window)
        return out, (lg if need_logits else None)

    def plain_step(state, batch):
        with mock.patch.object(fam, "fam_attention", plain_fam), \
                mock.patch.object(edt_kernel, "edt_row_pass",
                                  edt_kernel.edt_row_pass_ref):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile two bf16 stream steps and two train "
                         "steps; write the tables to FILE")
    args = ap.parse_args()

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
         cuda=torch.version.cuda)
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
    for out, (_, tri) in zip(outs, frames):
        if out.shape != (1, H, W) or out.dtype != torch.uint8:
            fail(f"bf16 matte {tuple(out.shape)} {out.dtype}")
        t = tri[..., 0]
        known = (t == 0) | (t == 255)
        if not torch.equal(out[known], t[known]):
            fail("bf16 matte: known pixels differ from the trimap")
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
    del sp, model, frames, state, f_prev, f_cur, f_next
    torch.cuda.empty_cache()

    # -- 6. training kernels against their plain versions -----------------------
    logits_res = check_fam_logits(fam, fam_kernel)
    edt_train_res = check_edt_train(edt_kernel)

    # -- 7. the video trainer, f32, full width and depth -------------------------
    train_counts, val_counts = train_phase(fam, edt_kernel, cuda_build,
                                           args.profile)

    # every row: the launches are its own path's (counts set to 0 just
    # before the path, read just after), the rest measured above
    edt = dict(name="edt_row", route="cuda",
               source="tcvom_tpu_torch/csrc/edt_row.cu",
               replaces="tcvom_tpu/ops/edt_pallas.py:39", library_ms=None)
    famk = dict(route="cuda", source="tcvom_tpu_torch/csrc/fam_window.cu",
                library_ms=None)
    kernels = [
        dict(edt, launches=counts["edt_row"], **edt_res),
        dict(edt, launches=train_counts["edt_row"], **edt_train_res),
        dict(famk, name="fam_window",
             replaces="tcvom_tpu/ops/fam_pallas.py:190",
             launches=counts["fam_window"], **fam_res[torch.bfloat16]),
        dict(famk, name="fam_window",
             replaces="tcvom_tpu/ops/fam_pallas.py:190",
             launches=f32_counts["fam_window"], **fam_res[torch.float32]),
        dict(famk, name="fam_window_logits",
             replaces="tcvom_tpu/ops/fam_pallas.py:38",
             launches=train_counts["fam_window_logits"],
             **logits_res[(6, 64, 64, 256)]),
        dict(famk, name="fam_window_logits",
             replaces="tcvom_tpu/ops/fam_pallas.py:97",
             launches=val_counts["fam_window_logits"],
             **logits_res[(12, 68, 120, 256)]),
    ]
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
