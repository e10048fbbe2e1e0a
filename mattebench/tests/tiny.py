"""A checkout of the benchmark at a size a CPU test run holds: the repo's
``BENCHMARK.json`` and ``mattebench/`` copied to a folder, FBA cut to one
block a stage, frames of 64 x 64 in f32, clips of 3 frames (so that the
window's first flushed matte, which the check always reads, comes third
however slow the CPU), the limits of f32 against the f32 reference."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TRIMAP = {"unknown": [12, 52, 8, 56], "foreground": [24, 40, 20, 44],
          "shift": 4}
# the program's plain path in f32 against the f32 reference: the same
# arithmetic, so the mattes agree to a level at most here and there
F32_LIMITS = {"matte_mad_max": 0.5, "known_mismatch": 0}


def make_root(dest: Path, streams: int = 2, dtype: str = "float32") -> Path:
    """A tiny checkout at ``dest`` (the program is imported from the repo)."""
    dest = Path(dest)
    shutil.copytree(REPO / "mattebench", dest / "mattebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        if "layers" in cfg:
            cfg["layers"] = [1, 1, 1, 1]
        cfg["limits"]["float32"] = F32_LIMITS
        (dest / c["file"]).write_text(json.dumps(cfg))
    for f in (dest / "mattebench" / "traffic").glob("*.json"):
        p = json.loads(f.read_text())
        p.update(height=64, width=64, dtype=dtype, clip_frames=3,
                 pool_frames=4, trimap=TRIMAP, warmup_clips=1,
                 warmup_frames=2, check_steps=2,
                 streams=min(p["streams"], streams))
        f.write_text(json.dumps(p))
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest
