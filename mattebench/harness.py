"""One run of one cell: set-up, the timed window, the check, the record
the metric readers read.

Everything that belongs to a configuration, a traffic mix, a kernel or a
metric is found by name (``lookup.py``): ``BENCHMARK.json`` names the
cell's configuration file and traffic mix (``mattebench/traffic/<mix>.json``,
whose ``kind`` names the generator ``mattebench/traffic/<kind>.py``); the
configuration's ``method`` names its reference model
(``mattebench/reference/<method>.py``) and its ``kernels`` their work
(``mattebench/kernels/<kernel>.py``); each metric is read by
``mattebench/metrics/<metric>.py`` (``read(record)``: a number, or None
where it finds nothing to read), and a quantity split by the cells it is
reported in, ``<metric>.<part>``, by that file where it has none of its
own. All of it is looked for under the cell's root.

The window drives ``tcvom_tpu_torch.infer.predict.StreamingPredictor``:
each step uploads every stream's next uint8 frame and trimap from pinned
host memory, calls ``step``, queues the matte's copy back to pinned host
memory behind an event, and waits for the matte of ``inflight`` steps
before; at each clip's end ``flush`` and a new clip.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

import torch

from mattebench import check, counts, trace, weights
from mattebench.lookup import HERE, Refused, load_module, package_module

# share of the trimaps' unknown pixels whose matte must lie strictly
# between 0 and 255 before a comparison of mattes says something
# (chip_smoke.LIVE_SHARE)
LIVE_SHARE = 0.01
PROFILE_TRIES = 3


class Cell:
    """A workload of ``BENCHMARK.json`` under ``root``: its configuration,
    traffic and the metrics it reports."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads(
            (self.root / configs[self.workload["config"]]["file"]).read_text())
        self.here = self.root / "mattebench"
        self.traffic = json.loads((self.here / "traffic" /
                                   f"{self.workload['traffic']}.json").read_text())
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]
        # a method or a kernel with no module refuses every run, at once
        package_module("reference", self.config["method"], self.here)
        for kernel in self.config["kernels"]:
            package_module("kernels", kernel, self.here)

    def metric(self, spec: dict):
        name = spec["name"]
        path = self.here / "metrics" / f"{name}.py"
        if not path.is_file():
            path = self.here / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, "mattebench_metric_" + name.replace(".", "_"))

    def make_traffic(self, seed: int, device):
        kind = self.traffic["kind"]
        gen = load_module(self.here / "traffic" / f"{kind}.py",
                          "mattebench_traffic_" + kind)
        return gen.make(self.traffic, seed, device)


def build_program(config: dict, state_dict: dict, dtype, device):
    """The program's stream for ``config`` with the benchmark's weights."""
    from tcvom_tpu_torch.infer.predict import StreamingPredictor
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.models.registry import build_model

    kw = {"layers": tuple(config["layers"])} if "layers" in config else {}
    model = build_model(config["model"], agg_window=config["agg_window"],
                        agg_reduction=config["agg_reduction"], device=device,
                        **kw)
    model.load_state_dict(state_dict, strict=True)
    cfg = TaskConfig(model=config["model"], agg_window=config["agg_window"],
                     agg_reduction=config["agg_reduction"])
    return StreamingPredictor(model, cfg, dtype=dtype, fgbg=False,
                              quantize=True, device=device)


class Driver:
    """The closed loop over a predictor ``sp`` and a traffic's pools.

    ``iterate()`` runs one step (or a clip's flush), queues its matte's
    readback and waits until at most ``inflight`` are outstanding; each
    delivered matte goes to ``on_matte((handed_s, clip_frame, last_frame),
    host, arrival_s)`` (its host buffer is reused afterwards).
    ``clip_frames`` (default the traffic's) sets the clip's length."""

    def __init__(self, sp, traffic, device, on_matte, spans: bool = False,
                 clip_frames: int | None = None):
        self.sp, self.traffic, self.dev = sp, traffic, device
        self.clip_frames = clip_frames or traffic.clip_frames
        self.cuda = device.type == "cuda"
        self.on_matte = on_matte
        self.spans = spans
        shape = (traffic.streams, traffic.height, traffic.width)
        self.ring = [torch.empty(shape, dtype=torch.uint8, pin_memory=self.cuda)
                     for _ in range(traffic.inflight + 2)]
        self.queued = 0
        self.outstanding: deque = deque()
        self.pending: deque = deque()
        self.state = None
        self.clip_frame = 0
        self.host_steps: list[float] = []
        self.encoded = self.decoded = 0
        self.frames_decoded: list[int] = []     # clip frames decoded

    def span(self, what: str):
        return span(what) if self.spans else contextlib.nullcontext()

    def upload(self, clip_frame: int):
        img_h, tri_h = self.traffic.batch(clip_frame)
        if not self.cuda:
            return img_h.clone(), tri_h.clone()
        img = torch.empty(img_h.shape, dtype=torch.uint8, device=self.dev)
        tri = torch.empty(tri_h.shape, dtype=torch.uint8, device=self.dev)
        img.copy_(img_h, non_blocking=True)
        tri.copy_(tri_h, non_blocking=True)
        return img, tri

    def queue(self, out: torch.Tensor, info: tuple):
        with self.span("readback"):
            host = self.ring[self.queued % len(self.ring)]
            self.queued += 1
            host.copy_(out, non_blocking=True)
            ready = None
            if self.cuda:
                ready = torch.cuda.Event()
                ready.record()
            self.outstanding.append((ready, host, info))
            self.decoded += 1
            self.frames_decoded.append(info[1])

    def finish_one(self):
        ready, host, info = self.outstanding.popleft()
        if ready is not None:
            ready.synchronize()
        self.on_matte(info, host, time.perf_counter())

    def iterate(self) -> None:
        last = self.clip_frames - 1
        if self.clip_frame > last:
            with self.span("clip_reset"):
                out = self.sp.flush(self.state)
            self.queue(out, self.pending.popleft())
            self.state, self.clip_frame = None, 0
        else:
            handed = time.perf_counter()
            with self.span("upload"):
                img, tri = self.upload(self.clip_frame)
            with self.span("step"):
                t0 = time.perf_counter()
                self.state, out = self.sp.step(self.state, img, tri)
                self.host_steps.append((time.perf_counter() - t0) * 1e3)
            self.encoded += 1
            self.pending.append((handed, self.clip_frame, last))
            self.clip_frame += 1
            if out is not None:
                self.queue(out, self.pending.popleft())
        with self.span("wait"):
            while len(self.outstanding) > self.traffic.inflight:
                self.finish_one()

    def drain(self) -> None:
        while self.outstanding:
            self.finish_one()


def span(what: str):
    """A host span the profiler records (``mattebench.<what>``)."""
    return torch.profiler.record_function(trace.SPAN + what)


def wrap_spans(sp) -> None:
    """Open a host span around the predictor's ``encode`` and ``decode``
    (this instance's), inside which the profiler files their launches."""
    for name in ("encode", "decode"):
        inner = getattr(sp, name)

        def wrapped(*args, _inner=inner, _name=name):
            with span(_name):
                return _inner(*args)

        setattr(sp, name, wrapped)


def live_share(mattes: list, traffic) -> float:
    """Share of the trimaps' unknown pixels whose matte lies strictly
    between 0 and 255, over ``(clip_frame, mattes)`` pairs."""
    inside = total = 0
    for clip_frame, m in mattes:
        tri = traffic.batch(clip_frame)[1][..., 0]
        o = m[(tri > 0) & (tri < 255)]
        inside += int(((o > 0) & (o < 255)).sum())
        total += o.numel()
    return inside / max(total, 1)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The cell's set-up: the traffic's pools, the benchmark's weights
    (kept on the host for the reference) and the program's predictor;
    and the work it counts for the traced run."""

    here = HERE     # where its kernels' work is found: its cell's root

    def __init__(self, cell: Cell, seed: int, device):
        dev = torch.device(device)
        config = cell.config
        self.phases: dict[str, float] = {}
        clock = [time.perf_counter()]

        def phase(name):
            now = time.perf_counter()
            self.phases[name] = now - clock[0]
            clock[0] = now

        if dev.type == "cuda":
            from tcvom_tpu_torch.ops import cuda_build
            torch.cuda.init()
            phase("cuda_init")
            cuda_build.build(config["kernels"])
            phase("kernels")
        self.dev, self.config, self.params = dev, config, cell.traffic
        self.here = cell.here
        self.traffic = traffic = cell.make_traffic(seed, dev)
        phase("traffic")
        sd = weights.make_state_dict(config, seed, dev, traffic.batch(0))
        phase("weights")
        self.sp = build_program(config, sd, traffic.dtype, dev)
        phase("program")
        self.state_dict = {k: v.cpu() for k, v in sd.items()}
        del sd

    def kernels(self):
        """The work modules of the configuration's kernels."""
        return [package_module("kernels", k, self.here)
                for k in self.config["kernels"]]

    def flop_per_matte(self) -> float:
        """FLOP of one matte: the reference's encode and head on the meta
        device, and what the kernels compute beyond what that count sees
        (FAM's attention). Only the traced run reads it (``step_mfu``)."""
        tp = self.traffic
        enc, head = counts.flop_per_frame(self.config, tp.height, tp.width)
        return enc + head + sum(k.flop_per_matte(self) for k in self.kernels()
                                if hasattr(k, "flop_per_matte"))

    def warm_up(self, spans: bool) -> float:
        """Short clips through every path of the window (a clip's first
        step, the steps, the flush); the mattes' live share."""
        mattes: list = []
        driver = Driver(self.sp, self.traffic, self.dev,
                        lambda info, host, t: mattes.append((info[1], host.clone())),
                        spans=spans, clip_frames=self.params["warmup_frames"])
        for _ in range(self.params["warmup_clips"]):
            for _ in range(self.params["warmup_frames"] + 1):
                driver.iterate()
            driver.drain()
        return live_share(mattes, self.traffic)

    def work(self, encodes: int, frames_decoded: list) -> dict:
        """Bytes, operations and the peak they are held to, by kernel, of
        ``encodes`` encodes and the decodes of these clip frames."""
        return {name: k.work(self, encodes, frames_decoded)
                for name, k in zip(self.config["kernels"], self.kernels())}


class Sampler:
    """The mattes the check reads, drawn from the seed among those
    delivered in the window: the window's first (a clip's first frame) and
    first flushed (a clip's last frame), and ``k`` more by reservoir
    sampling."""

    def __init__(self, seed: int, k: int):
        self.rng, self.k = random.Random(seed), k
        self.samples: dict[int, check.Sample] = {}
        self.reservoir: list[int] = []
        self.others = 0
        self.flushed = False

    def offer(self, unit: int, clip_frame: int, last: int, host) -> None:
        if unit == 0 or (clip_frame == last and not self.flushed):
            self.flushed |= clip_frame == last
        else:
            n = self.others
            self.others += 1
            if n < self.k:
                self.reservoir.append(unit)
            else:
                j = self.rng.randrange(n + 1)
                if j >= self.k:
                    return
                del self.samples[self.reservoir[j]]
                self.reservoir[j] = unit
        self.samples[unit] = check.Sample(clip_frame, last, host.clone())


def profile_steps(driver: Driver, steps: int) -> dict:
    """``steps`` iterations of the loop under ``torch.profiler`` (CPU and,
    on the card, CUDA activities) inside a ``mattebench.window`` span,
    synchronized and drained at the end: the reduced trace, the host
    interval that this and the trace's reading took, and what these
    iterations queued."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if driver.cuda:
        acts.append(ProfilerActivity.CUDA)
    decoded0 = len(driver.frames_decoded)
    encoded0 = driver.encoded
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        with driver.span("window"):
            for _ in range(steps):
                driver.iterate()
        sync(driver.dev)
    driver.drain()
    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        reduced = trace.reduce_chrome_trace(tmp)
    finally:
        os.unlink(tmp)
    return {"profile": reduced, "host_s": (t0, time.perf_counter()),
            "handed": driver.encoded - encoded0,
            "frames_decoded": driver.frames_decoded[decoded0:]}


def issue_steps(driver: Driver, steps: int) -> list[float]:
    """Host ms of ``steps`` calls of the predictor's ``step``, each made
    after a synchronize, onto an empty launch queue: the host's own cost
    of issuing a step. (In the window two steps stay queued, so a step
    call returns only as fast as the device makes room, and times the
    device.) Run after the window; their mattes count nowhere."""
    first = len(driver.host_steps)
    while len(driver.host_steps) - first < steps:
        sync(driver.dev)
        driver.iterate()
    driver.drain()
    return driver.host_steps[first:]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float, log=None) -> dict:
    """Set up, warm up, run the window, check. Returns the record the
    readers read, the checks, the counts and the device's readings.
    ``log(line)`` prints a line to standard error."""
    log = log or (lambda line: print(f"mattebench: {line}", file=sys.stderr,
                                      flush=True))
    prog = Program(cell, seed, device)
    dev, tp, params = prog.dev, prog.traffic, prog.params
    if traced:
        wrap_spans(prog.sp)
    t0 = time.perf_counter()
    share = prog.warm_up(traced)
    prog.phases["warm_up"] = time.perf_counter() - t0
    log("set-up seconds by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in prog.phases.items()))
    log(f"live_share {share:.6f} of the trimaps' unknown pixels "
        f"strictly between 0 and 255 in the warm-up mattes (least "
        f"{LIVE_SHARE})")
    if share < LIVE_SHARE:
        raise Refused(f"the mattes are saturated (live share {share:.6f} < "
                      f"{LIVE_SHARE}): a comparison of them says nothing")

    arrivals: list = []
    sampler = Sampler(seed, params["check_steps"])
    bounds: dict = {"end": None}

    def on_matte(info, host, t):
        # the window closes on the first matte that reaches the host once
        # ``seconds`` have passed, so that it holds whole steps only
        if bounds["end"] is not None:
            return
        handed, clip_frame, last = info
        arrivals.append((handed - bounds["start"], t - bounds["start"]))
        sampler.offer(len(arrivals) - 1, clip_frame, last, host)
        if t >= bounds["due"]:
            bounds["end"] = t

    driver = Driver(prog.sp, tp, dev, on_matte, spans=traced)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    bounds.update(start=start, due=start + seconds)
    sub = None
    while bounds["end"] is None:
        if (traced and sub is None and time.perf_counter() - start
                >= params["profile_at"] * seconds):
            sub = profile_steps(driver, params["profile_steps"])
        else:
            driver.iterate()
    queued = driver.decoded
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.drain()
    record = {"setup_s": start - t_process, "seconds": bounds["end"] - start,
              "streams": tp.streams, "dtype": params["dtype"],
              "mattes": [list(a) for a in arrivals]}
    out = {"record": record, "memory_peak_bytes": int(peak),
           "attempted": queued * tp.streams, "live_share": share}
    if traced:
        record["host_steps_ms"] = issue_steps(driver, params["issue_steps"])
        out.update(traced_parts(prog, driver, sub, record, bounds, log))
    prog.sp = None
    del driver
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    samples = [sampler.samples[u] for u in sorted(sampler.samples)]
    want = check.reference_mattes(prog.config, prog.state_dict, tp, samples,
                                  dev)
    result = check.compare(samples, want, tp,
                           prog.config["limits"].get(params["dtype"], {}))
    out.update(result, samples=samples, want=want, program=prog)
    return out


def traced_parts(prog: Program, driver: Driver, sub: dict | None,
                 record: dict, bounds: dict, log) -> dict:
    """The traced run's additions to ``record`` (the rate outside the
    profiled sub-window, the profile and its work counts) and
    the device's busy and window seconds and the breakdown. A sub-window
    that recorded no device operation is profiled again after the
    window."""
    if sub is None:
        raise Refused("the window ended before its profiled sub-window: "
                      "give the run more seconds")
    t0, t1 = (t - bounds["start"] for t in sub["host_s"])
    seconds = record["seconds"]
    outside = [a for a in record["mattes"] if not t0 <= a[1] <= t1]
    record["rate_outside"] = (len(outside) * record["streams"]
                              / (t0 + max(seconds - t1, 0.0)))
    record["profiled_s"] = [t0, t1]
    log(f"profiled sub-window {t0:.3f}-{t1:.3f} s into the "
        f"window, its trace read; {len(outside)} matte batches outside it")
    tries = 1
    while (driver.cuda and not sub["profile"]["ops"]
           and tries < PROFILE_TRIES):
        log("the profiled sub-window recorded no device "
            "operation; profiling the steps after the window")
        sub = profile_steps(driver, prog.params["profile_steps"])
        driver.drain()
        tries += 1
    record["flop_per_matte"] = prog.flop_per_matte()
    prof = sub["profile"]
    if driver.cuda and not prof["ops"]:
        raise Refused(f"the profiler recorded no device operation in {tries} "
                      "sessions")
    prof["frames_encoded"] = sub["handed"] * driver.traffic.streams
    prof["mattes_decoded"] = len(sub["frames_decoded"]) * driver.traffic.streams
    prof["work"] = prog.work(sub["handed"], sub["frames_decoded"])
    record["profile"] = prof
    if not prof["ops"]:
        return {}
    lo, hi = trace.device_window(prof)
    return {"device_extra": {"busy_s": trace.busy_us(prof) / 1e6,
                             "window_s": (hi - lo) / 1e6},
            "breakdown": {"device_ops": trace.top_ops(prof),
                          "idle_gaps": trace.labelled_gaps(prof)}}
