"""A new method and a new kernel join the benchmark as new files and
manifest entries only. In a copy of ``BENCHMARK.json`` and ``mattebench/``
a toy method with a 1-channel trimap gets its configuration, its
reference, a traffic mix, its kernel's work and that kernel's roofline
reader, and a cell: the copy's own harness (no program under test beside
it) then builds the cell, draws and calibrates the weights, mattes, counts
the FLOP, dispatches the kernels' work and reads the roofline, while no
file the copy had differs from the tree's. A method or a kernel with no
module refuses the run, naming the file it looked for."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mattebench import harness, weights
from mattebench.tests.tiny import REPO, TRIMAP

TOY_REFERENCE = '''"""A toy matting method: RGB and a 1-channel trimap in, a conv and a
BatchNorm at OS 2, a conv to the FAM's channels at OS 8, one conv head."""
import torch
import torch.nn.functional as F

from mattebench.reference.common import (IMG_MEAN, IMG_SCALE, IMG_STD,
                                         batch_norm, conv, nchw,
                                         resize_bilinear)


def spec(config):
    c = config["fam_channels"]
    out = {"encoder.conv1.weight": (16, 4, 3, 3),
           "encoder.conv2.weight": (c, 16, 3, 3),
           "head.conv.weight": (1, c, 3, 3), "head.conv.bias": (1,),
           "encoder.bn1.num_batches_tracked": ()}
    for s in ("weight", "bias", "running_mean", "running_var"):
        out["encoder.bn1." + s] = (16,)
    for n in ("query", "key", "value"):
        out[f"decoder.fam.{n}_conv.weight"] = (c, c, 3, 3)
        out[f"decoder.fam.{n}_conv.bias"] = (c,)
    return out


def prepare(img_u8, tri_u8):
    dev = img_u8.device
    scaled = img_u8.float().flip(-1) * IMG_SCALE
    imgs = (scaled - torch.tensor(IMG_MEAN, device=dev)) / torch.tensor(
        IMG_STD, device=dev)
    s = tri_u8.float() * IMG_SCALE
    return dict(x=nchw(torch.cat([imgs, s], dim=-1)), extras=None,
                trimask=nchw(((s > 0) & (s < 1)).float()))


def encode(ar, sd, x, extras):
    h = conv(ar, x.to(ar.dtype), sd["encoder.conv1.weight"], None, 2, 1)
    h = F.relu(batch_norm(ar, h, sd, "encoder.bn1"))
    return {"size": x.shape[-2:]}, conv(ar, h, sd["encoder.conv2.weight"],
                                        None, 4, 1)


def head(ar, sd, enc, v):
    up = resize_bilinear(v.to(ar.dtype), enc["size"])
    out = conv(ar, up, sd["head.conv.weight"], sd["head.conv.bias"], padding=1)
    return torch.sigmoid(out).to(ar.wide)
'''

TOY_KERNEL = '''"""toy_pool: one pass over every pixel of each encoded frame."""
from mattebench import counts


def work(program, encodes, frames_decoded):
    tp = program.traffic
    return [float(encodes * tp.streams * tp.height * tp.width), 0.0,
            counts.PEAK_F32_ADD_MIN]
'''

TOY_METRIC = '''"""toy_pool_roofline: the toy kernel's bound over its device time."""
from mattebench import counts


def read(record):
    return counts.roofline(record, "toy_pool", "toy_pool")
'''

TOY_CONFIG = {"name": "toy", "source": "a test", "model": "toy", "method": "toy",
              "fam_channels": 8, "agg_window": 3, "agg_reduction": 1,
              "kernels": ["toy_pool"], "calibrate_batch_norm": True,
              "limits": {}}

TOY_TRAFFIC = {"kind": "closed_stream", "streams": 2, "height": 64, "width": 64,
               "dtype": "float32", "clip_frames": 3, "pool_frames": 3,
               "inflight": 1, "trimap": TRIMAP, "warmup_clips": 1,
               "warmup_frames": 2, "check_steps": 2, "profile_steps": 2,
               "profile_at": 0.4, "issue_steps": 2}

NEW_FILES = {"mattebench/configs/toy.json": json.dumps(TOY_CONFIG),
             "mattebench/traffic/toy_small.json": json.dumps(TOY_TRAFFIC),
             "mattebench/reference/toy.py": TOY_REFERENCE,
             "mattebench/kernels/toy_pool.py": TOY_KERNEL,
             "mattebench/metrics/toy_pool_roofline.py": TOY_METRIC}

# run in the copy, with only the copy on the path: its own harness
DRIVE = '''
import json, sys
import torch
torch.set_num_threads(2)
import mattebench
from mattebench import counts, harness, reference, weights

cell = harness.Cell(".", "toy_cell")
tp = cell.make_traffic(2**31 + 5, "cpu")
sd = weights.make_state_dict(cell.config, 2**31 + 5, "cpu", tp.batch(0))
ref = reference.Reference(cell.config, sd)
with torch.no_grad():
    matte = ref.matte(*(ref.encode(*tp.batch(i)) for i in range(3)))
prog = object.__new__(harness.Program)
prog.config, prog.traffic, prog.params = cell.config, tp, cell.traffic
prog.here = cell.here
work = prog.work(3, [0, 1, 2])
record = {"profile": {"ops": [["toy_pool_kernel", 0.0, 4.0, 1]],
                      "work": work}}
print(json.dumps({
    "package": mattebench.__file__,
    "program": sorted(m for m in sys.modules if m.startswith("tcvom")),
    "per_layer": [m["name"] for m in cell.per_layer],
    "running_mean": sd["encoder.bn1.running_mean"].abs().sum().item(),
    "running_var": sd["encoder.bn1.running_var"].tolist(),
    "matte": [list(matte.shape), str(matte.dtype)],
    "flop_per_frame": counts.flop_per_frame(cell.config, 64, 64),
    "flop_per_matte": prog.flop_per_matte(),
    "work": work,
    "roofline": cell.metric({"name": "toy_pool_roofline"}).read(record)}))
'''


def copy_root(dest: Path) -> Path:
    shutil.copytree(REPO / "mattebench", dest / "mattebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def add_toy(root: Path) -> None:
    """The toy's files, and its entries appended to the manifest."""
    for rel, text in NEW_FILES.items():
        (root / rel).write_text(text)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy", "source": "a test",
                                "file": "mattebench/configs/toy.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "toy_cell", "config": "toy",
                                  "traffic": "toy_small", "chips": 1,
                                  "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "mattes_per_s":
            m["workloads"].append("toy_cell")
    manifest["per_layer"].append({
        "name": "toy_pool_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "Kernels", "moves": "mattes_per_s",
        "workloads": ["toy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def test_a_method_and_a_kernel_join_as_new_files(tmp_path):
    root = copy_root(tmp_path)
    add_toy(root)

    files = {p.relative_to(root).as_posix() for p in root.rglob("*")
             if p.is_file()}
    old = {f for f in files if (REPO / f).is_file()}
    assert files - old == set(NEW_FILES)
    for f in old - {"BENCHMARK.json"}:
        assert (root / f).read_bytes() == (REPO / f).read_bytes(), f
    was = json.loads((REPO / "BENCHMARK.json").read_text())
    now = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert now[key][:len(was[key])] == was[key]
    for a, b in zip(was["end_to_end"], now["end_to_end"]):
        if a["name"] == "mattes_per_s":
            a["workloads"].append("toy_cell")
        assert b == a

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    got = json.loads(done.stdout.splitlines()[-1])

    assert Path(got["package"]).resolve().parent == (root / "mattebench").resolve()
    assert got["program"] == []
    assert "toy_pool_roofline" in got["per_layer"]
    assert got["running_mean"] > 0 and got["running_var"] != [1.0] * 16
    assert got["matte"] == [[2, 64, 64], "torch.uint8"]
    # by hand, 2 x multiply-adds at the output's grid: conv1 at 32 x 32,
    # conv2 and the FAM's three projections at 8 x 8; the head at 64 x 64
    enc = 2 * (16 * 4 * 9 * 32 * 32 + 8 * 16 * 9 * 64 + 3 * 8 * 8 * 9 * 64)
    head = 2 * 8 * 9 * 64 * 64
    assert got["flop_per_frame"] == [float(enc), float(head)]
    assert got["flop_per_matte"] == float(enc + head)
    assert got["work"] == {"toy_pool": [3 * 2 * 64 * 64, 0.0, 132 * 128 * 1.98e9]}
    assert got["roofline"] == pytest.approx(
        100.0 * 3 * 2 * 64 * 64 / 3.35e12 / 4e-6, rel=1e-12)


@pytest.mark.parametrize("part, missing", [
    ("method", "mattebench/reference/nope.py"),
    ("kernels", "mattebench/kernels/nope_kernel.py")])
def test_a_name_with_no_module_refuses(tmp_path, part, missing):
    root = copy_root(tmp_path)
    path = root / "mattebench/configs/vmn_gca.json"
    cfg = json.loads(path.read_text())
    if part == "method":
        cfg["method"] = "nope"
    else:
        cfg["kernels"].append("nope_kernel")
    path.write_text(json.dumps(cfg))
    # the cell looks in its own root, the copy, and names the file there
    with pytest.raises(harness.Refused, match=re.escape(str(root / missing))):
        harness.Cell(root, "gca_batch8")
    if part == "method":
        # outside a cell, in the imported package's folder
        with pytest.raises(harness.Refused, match=re.escape(str(REPO / missing))):
            weights.make_state_dict(cfg, 1, "cpu")


def test_a_cell_finds_its_method_and_kernels_in_its_own_root(tmp_path):
    """A module that the imported package has and the cell's root lacks
    refuses the cell."""
    root = copy_root(tmp_path)
    (root / "mattebench/kernels/edt_row.py").unlink()
    with pytest.raises(harness.Refused,
                       match=re.escape(str(root / "mattebench/kernels/edt_row.py"))):
        harness.Cell(root, "fba_batch4")
    harness.Cell(root, "gca_batch8")
