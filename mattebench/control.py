"""The readings that a cell's limits are set from, on the card: the
program's numbers over many seeds, and the control's.

    python3 mattebench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --seconds 3 --out <file.json>

For each seed, in this one process: a run of the cell (set-up, a short
window at the cell's own load, the check against the reference), whose
compared numbers are the program's reading. For each control seed also
the control: the reference computed in the next precision below the
cell's, bf16 with every convolution's and matrix product's operands
rounded to float8 e4m3 (``reference.FP8``), put in the program's place:
its mattes of the same sampled frames, compared with the f32 reference
as the program's are. Writes every reading to ``--out`` (JSON) and prints
a summary line per seed. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_reading(out: dict, device) -> dict:
    """The control's numbers on a finished run's samples."""
    from mattebench import check, reference

    prog = out["program"]
    ctl = check.reference_mattes(prog.config, prog.state_dict, prog.traffic,
                                 out["samples"], device, reference.FP8)
    stand_in = [check.Sample(s.clip_frame, s.last, m)
                for s, m in zip(out["samples"], ctl)]
    return check.compare(stand_in, out["want"], prog.traffic, {})["numbers"]


def readings(root: Path, workload: str, seeds: list[int],
             control_seeds: list[int], seconds: float, device: str) -> list:
    import torch

    from mattebench import harness

    cell = harness.Cell(root, workload)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, seconds, False, device, t0)
        row = {"seed": seed, "program": out["numbers"],
               "mattes": out["mattes"], "live_share": out["live_share"],
               "mattes_per_s": len(out["record"]["mattes"])
               * out["record"]["streams"] / out["record"]["seconds"]}
        if seed in control_seeds:
            row["control"] = control_reading(out, device)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card is available", file=sys.stderr)
        return 2
    rows = readings(ROOT, args.workload, args.seeds, args.control_seeds,
                    args.seconds, "cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"workload": args.workload, "card": torch.cuda.get_device_name(0),
         "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
