#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tcvom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]

From the repo root, on a machine with a CUDA card and the CUDA toolkit:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: both CUDA kernels from tcvom_tpu_torch/csrc, with ptxas's
   register and shared-memory report;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (EDT row pass bit-exact; FAM attention f32 to 1e-5, bf16
   to 2e-2), with CUDA-event times and the card's bound for the same work;
4. the main path in f32 at full width (vmn_fba, 1088x1920, window 7,
   random weights from a seed): once through the kernels, once with the
   plain versions substituted; the uint8 mattes agree within one level;
5. the main path in bf16, as users run it: the launch counts must equal
   the encodes (EDT) and decodes (FAM); steady-state times and memory.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. ``--profile FILE`` adds a torch.profiler breakdown of
two bf16 steps, its table written to FILE.
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
PEAK_OPS = {torch.float32: 67e12,             # f32 outside the tensor cores
            torch.bfloat16: 989e12}           # bf16 tensor cores, dense


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


def check_edt(edt_kernel, distance, tri):
    """Kernel A at the main path's input (the column pass of this frame's
    bg/fg planes, [2*1088, 1920], T = 256) and at a ragged shape."""
    seeds = torch.stack([tri[0, ..., 0] == 0, tri[0, ..., 0] == 255])
    g = distance._dist1d_along_axis(seeds, axis=1, truncate=256)
    g2 = torch.clamp_max(g * g, 1e7).reshape(-1, W).contiguous()
    rng = np.random.RandomState(1)
    ragged = torch.from_numpy(np.where(
        rng.rand(130, 70) < 0.05, 0.0,
        rng.randint(0, 3000, (130, 70))).astype(np.float32)).cuda()
    for x, t in ((g2, 256), (ragged, 32)):
        got = edt_kernel.edt_row_pass_cuda(x, t)
        torch.cuda.synchronize()
        want = edt_kernel.edt_row_pass_ref(x, t)
        if not torch.equal(got, want):
            fail(f"edt_row {tuple(x.shape)} T={t}: not bit-exact, max err "
                 f"{(got - want).abs().max().item()}")
        emit(phase="check", kernel="edt_row", shape=list(x.shape), trunc=t,
             tolerance="bit-exact", max_abs_err=0.0)
    ms = time_ms(lambda: edt_kernel.edt_row_pass_cuda(g2, 256), 20)
    plain_ms = time_ms(lambda: edt_kernel.edt_row_pass_ref(g2, 256), 3)
    r, w = g2.shape
    b_ms, b_by = bound(2 * r * w * 4, 3 * 256 * r * w, torch.float32)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def fam_counts(mask, c, window):
    """Bytes (q, k, mask in; out) and operations (a multiply-add for the
    dot and one for the sum, per channel of each in-frame neighbour of each
    pixel inside the mask: outside it the output is 0 whatever q and k)."""
    b, h, w, _ = mask.shape
    r = window // 2
    ny = torch.tensor([min(y + r, h - 1) - max(y - r, 0) + 1
                       for y in range(h)], dtype=torch.float64)
    nx = torch.tensor([min(x + r, w - 1) - max(x - r, 0) + 1
                       for x in range(w)], dtype=torch.float64)
    inside = (mask[..., 0] != 0).double().cpu()
    nbytes = (3 * b * h * w * c + b * h * w) * mask.element_size()
    return nbytes, 4.0 * c * (inside * torch.outer(ny, nx)).sum().item()


def check_fam(fam, fam_kernel):
    """Kernel B at the main path's [prev; next] batch in f32 and bf16, and
    at a narrow shape."""
    rng = np.random.RandomState(2)
    results = {}
    for shape, window, dtype in (((2, 136, 240, 256), WINDOW, torch.float32),
                                 ((2, 136, 240, 256), WINDOW, torch.bfloat16),
                                 ((2, 16, 24, 32), 3, torch.float32),
                                 ((2, 16, 24, 32), 3, torch.bfloat16)):
        b, h, w, c = shape
        q = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        k = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        m = torch.from_numpy((rng.rand(b, h, w, 1) > 0.4).astype(np.float32))
        q, k, m = (t.to("cuda", dtype) for t in (q, k, m))
        got = fam_kernel.fam_window(q, k, m, window)
        torch.cuda.synchronize()
        want, _ = fam.fam_attention_ref(q, k, m, window)
        atol = rtol = 1e-5 if dtype == torch.float32 else 2e-2
        if dtype == torch.float32:
            rtol = 0.0
        err = (got.float() - want.float()).abs()
        bad = (err > atol + rtol * want.float().abs()).sum().item()
        emit(phase="check", kernel="fam_window", shape=list(shape),
             window=window, dtype=str(dtype), atol=atol, rtol=rtol,
             max_abs_err=err.max().item(), violations=bad)
        if bad:
            fail(f"fam_window {shape} {dtype}: {bad} elements off")
        if h == 136:
            ms = time_ms(lambda: fam_kernel.fam_window(q, k, m, window), 20)
            plain_ms = time_ms(
                lambda: fam.fam_attention_ref(q, k, m, window), 3)
            b_ms, b_by = bound(*fam_counts(m, c, window), dtype)
            results[dtype] = dict(max_abs_err=err.max().item(), ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by)
            emit(phase="time", kernel="fam_window", dtype=str(dtype),
                 **results[dtype])
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile two bf16 steps; write the table to FILE")
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
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "entry function" in line):
                print(f"{name}: {line.strip()}", flush=True)

    # -- 3. kernels against their plain versions -------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = make_frames(12)
    edt_res = check_edt(edt_kernel, distance, frames[0][1])
    emit(phase="time", kernel="edt_row", **edt_res)
    fam_res = check_fam(fam, fam_kernel)

    # -- 4. main path, f32, kernels vs plain -----------------------------------
    cfg = TaskConfig(model="vmn_fba", agg_window=WINDOW)
    model = build_model("vmn_fba", agg_window=WINDOW,
                        generator=torch.Generator().manual_seed(0))
    sp32 = StreamingPredictor(model, cfg, fgbg=False, quantize=True)
    cuda_build.LAUNCHES.clear()
    got = run_stream(sp32, frames[:4])
    f32_counts = dict(cuda_build.LAUNCHES)

    def plain_fam(q, k, mask, window, need_logits=False):
        return fam.fam_attention_ref(q, k, mask, window)[0], None

    cuda_build.LAUNCHES.clear()
    with mock.patch.object(fam, "fam_attention", plain_fam), \
            mock.patch.object(edt_kernel, "edt_row_pass",
                              edt_kernel.edt_row_pass_ref):
        want = run_stream(sp32, frames[:4])
    if sum(cuda_build.LAUNCHES.values()):
        fail(f"the plain run launched kernels: {dict(cuda_build.LAUNCHES)}")
    diff = torch.stack([(g.int() - w.int()).abs() for g, w in zip(got, want)])
    same = (diff == 0).float().mean().item()
    emit(phase="main_f32", frames=4, launches=f32_counts,
         max_level_diff=diff.max().item(), identical_share=same)
    if f32_counts != {"edt_row": 4, "fam_window": 4}:
        fail(f"f32 launch counts {f32_counts}, want 4 encodes and 4 decodes")
    if diff.max().item() > 1 or same < 0.999:
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
        profile_steps(sp, state, img, tri, args.profile)

    kernels = [
        dict(name="edt_row", route="cuda",
             source="tcvom_tpu_torch/csrc/edt_row.cu",
             replaces="tcvom_tpu/ops/edt_pallas.py:39",
             launches=counts["edt_row"], library_ms=None, **edt_res),
        dict(name="fam_window", route="cuda",
             source="tcvom_tpu_torch/csrc/fam_window.cu",
             replaces="tcvom_tpu/ops/fam_pallas.py:190",
             launches=counts["fam_window"], library_ms=None,
             **fam_res[torch.bfloat16]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


def profile_steps(sp, state, img, tri, path):
    """Device time by kernel over two steady bf16 steps, and the device's
    busy share of the window's wall time."""
    import os
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = sp.step(state, img, tri)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    emit(phase="profile_bf16", steps=2, wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms,
         top=[[e.key[:80], e.self_device_time_total / 2e3] for e in top])


if __name__ == "__main__":
    main()
