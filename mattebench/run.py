"""Run one cell of the benchmark once, on the card this process is given.

    python3 mattebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
``tcvom_tpu_torch``. Prints progress, the live share and then each number
compared beside its limit on standard error, and one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics, read from a profiled sub-window), ``device`` and,
traced, ``breakdown``; ``checks`` comes last.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; it does not fall back to the CPU. A run that cannot
give a result (saturated mattes, no device time in the profile, a
metric a listed cell does not report) exits 3, and one that finds JAX or
the JAX package loaded once the window has closed exits 4.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tcvom_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_age() -> float | None:
    """Seconds since this process started, from ``/proc`` (None where
    there is none): what the interpreter took before this file ran."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not read (no nvidia-smi)"
    done = subprocess.run([smi, "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else \
        f"not read (nvidia-smi exited {done.returncode})"


def execute(root: Path, workload: str, seed: int, seconds: float,
            traced: bool, device: str, t_process: float, log=None) -> dict:
    """The run of a cell without the look for a card: set-up, window,
    check, and the result (without the card's name)."""
    from mattebench import check, harness

    log = log or (lambda line: print(f"mattebench: {line}", file=sys.stderr,
                                      flush=True))
    cell = harness.Cell(root, workload)
    out = harness.run_cell(cell, seed, seconds, traced, device, t_process,
                           log)
    metrics = {}
    for spec in (cell.per_layer if traced else cell.end_to_end):
        value = cell.metric(spec).read(out["record"])
        if value is None:
            raise harness.Refused(f"metric {spec['name']} found nothing to "
                                  f"read in cell {workload}")
        metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    checks = out["checks"]
    log(f"{out['mattes']} mattes checked against the reference")
    result = {"correct": check.passed(checks, out["mattes"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": None, "count": cell.chips,
                         "memory_peak_bytes": out["memory_peak_bytes"],
                         **out.get("device_extra", {})},
              "live_share": out["live_share"]}
    if out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    age = process_age()
    t_args = time.perf_counter()

    import torch

    t_torch = time.perf_counter()
    from mattebench import harness

    def err(msg: str):
        print(f"mattebench: {msg}", file=sys.stderr, flush=True)

    if not torch.cuda.is_available():
        err("no CUDA card is available; the benchmark runs on the card only")
        return 2
    try:
        chips = harness.Cell(ROOT, args.workload).chips
    except (harness.Refused, KeyError, OSError) as e:
        err(f"cannot read the cell: {e}")
        return 2
    if torch.cuda.device_count() < chips:
        err(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
            "are visible")
        return 2
    now = time.perf_counter()
    err("seconds before set-up: the interpreter before this file "
        + ("not read" if age is None else
           f"{age - (t_args - T_PROCESS):.3f}")
        + f", arguments {t_args - T_PROCESS:.3f}, import torch "
        f"{t_torch - t_args:.3f}, the harness's imports and the card's "
        f"probe {now - t_torch:.3f}")
    try:
        result = execute(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_PROCESS, err)
    except harness.Refused as e:
        err(str(e))
        return 3
    bad = forbidden_modules()
    if bad:
        err(f"JAX or the JAX package is loaded: {', '.join(bad)}")
        return 4
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    checks = result.pop("checks")
    result["power_limit"] = power_limit()
    result["checks"] = checks
    err(f"card {result['power_limit']}")
    for name, c in checks.items():
        err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
