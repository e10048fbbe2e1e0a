"""The harness on the CPU: its traffic, its manifest, its metric readers
on a canned record, a cell and a metric added as files only, what it
imports, and whole runs at a tiny size, clean and with the timed path
broken underneath (``correct`` must come out false)."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from mattebench import harness, run
from mattebench.tests.tiny import REPO, make_root
from mattebench.traffic import closed_stream

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def stream(seed: int):
    params = json.loads((REPO / "mattebench/traffic/stream_b4.json").read_text())
    params.update(height=64, width=64, pool_frames=3,
                  trimap={"unknown": [12, 52, 8, 56],
                          "foreground": [24, 40, 20, 44], "shift": 4})
    return closed_stream.make(params, seed, "cpu")


def test_traffic_is_the_seeds():
    a, b, c = stream(2**31 + 5), stream(2**31 + 5), stream(2**31 + 6)
    assert torch.equal(a.frames, b.frames) and torch.equal(a.trimaps, b.trimaps)
    assert not torch.equal(a.frames, c.frames)
    assert not torch.equal(a.trimaps, c.trimaps)
    img, tri = a.batch(5)
    assert img.shape == (4, 64, 64, 3) and tri.shape == (4, 64, 64, 1)
    assert img.is_contiguous() and tri.is_contiguous()
    assert set(tri.unique().tolist()) == {0, 128, 255}
    assert a.window(0, 4) == (1, 0, 1) and a.window(4, 4) == (3, 4, 3)
    assert a.window(2, 4) == (1, 2, 3) and a.window(0, 0) == (0, 0, 0)


def test_manifest_names_units_and_files():
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = m["end_to_end"] + m["per_layer"]
    names = ([c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
             + [x["name"] for x in metrics]
             + [w["traffic"] for w in m["workloads"]]
             + [k for c in m["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(x["unit"]) for x in metrics)
    assert all(x["better"] in ("lower", "higher") for x in metrics)
    for group in (m["configs"], m["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    assert all(0.01 <= x["bound"] <= 0.25 for x in m["end_to_end"])
    reported = {w["name"]: {x["name"] for x in m["end_to_end"]
                            if w["name"] in x.get("workloads", [w["name"]])}
                for w in m["workloads"]}
    for x in m["per_layer"]:
        assert reader_file(x["name"]).exists()
        assert all(x["moves"] in reported[w] for w in x["workloads"])
    for x in m["end_to_end"]:
        assert reader_file(x["name"]).exists()
    for c in m["configs"]:
        assert c["file"].startswith("mattebench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (REPO / "mattebench/reference" / f"{cfg['method']}.py").exists()
        for k in cfg["kernels"]:
            assert (REPO / "mattebench/kernels" / f"{k}.py").exists()
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "mattebench/traffic" / f"{w['traffic']}.json").exists()
        assert len(reported[w["name"]] - {"setup_s"}) >= 1


def reader_file(name: str) -> Path:
    """The reader of a metric: its own file, else that of the quantity it
    splits (``<metric>.<part>``)."""
    own = REPO / "mattebench/metrics" / f"{name}.py"
    return own if own.exists() else own.with_name(name.split(".")[0] + ".py")


def test_the_host_paced_cell_has_metrics_of_its_own():
    """``fba_live``'s rate and per-layer metrics are split from the batch
    cells' (``<metric>.live``), so that its wider bound is its own; a
    split metric is read by the reader of the quantity it splits."""
    live = harness.Cell(REPO, "fba_live")
    assert [x["name"] for x in live.end_to_end] == [
        "mattes_per_s.live", "matte_p95_ms", "setup_s"]
    assert live.per_layer and all(x["name"].endswith(".live")
                                  for x in live.per_layer)
    bounds = {x["name"]: x["bound"] for x in live.end_to_end}
    for name in ("gca_batch8", "fba_batch4"):
        cell = harness.Cell(REPO, name)
        assert {x["name"]: x["bound"] for x in cell.end_to_end} == {
            "mattes_per_s": 0.02, "setup_s": 0.25}
        assert not any(x["name"].endswith(".live") for x in cell.per_layer)
    assert bounds["mattes_per_s.live"] == 0.25
    for x in live.end_to_end + live.per_layer:
        base = x["name"].removesuffix(".live")
        want = harness.load_module(reader_file(base), "reader_" + base)
        assert (live.metric(x).read(canned_record())
                == want.read(canned_record()))
    with pytest.raises(harness.Refused, match="nothing.py"):
        live.metric({"name": "nothing.live"})


def canned_record() -> dict:
    ops = [["void fam_window_mma_kernel<bf16>", 100.0, 10.0, 1],
           ["edt_row_kernel", 110.0, 5.0, 2],
           ["sm90_xmma_fprop", 120.0, 20.0, 3],
           ["Memcpy HtoD (Pinned -> Device)", 150.0, 10.0, 4]]
    return {
        "setup_s": 12.5, "seconds": 4.0, "streams": 2, "dtype": "bfloat16",
        "mattes": [[0.0, t / 1000.0] for t in range(21)],
        "host_steps_ms": [1.0, 2.0, 3.0],
        "rate_outside": 2.0, "flop_per_matte": 989e10,
        "profile": {
            "ops": ops,
            "launches": [[95.0, 1], [96.0, 2], [97.0, 3], [140.0, 4]],
            "spans": [["mattebench.window", 90.0, 80.0],
                      ["mattebench.encode", 94.0, 2.5],
                      ["mattebench.decode", 96.8, 1.0],
                      ["mattebench.upload", 139.0, 2.0],
                      ["mattebench.wait", 143.0, 5.0]],
            "frames_encoded": 1, "mattes_decoded": 2,
            "work": {"fam_window": [3.35e12 * 5e-6, 0.0, 989e12],
                     "edt_row": [0.0, 4.224e6, 33.4e12]},
        },
    }


@pytest.mark.parametrize("name, want", [
    ("setup_s", 12.5),
    ("mattes_per_s", 21 * 2 / 4.0),
    ("matte_p95_ms", 19.0),
    ("host_step_ms", 2.0),
    ("encode_ms", 0.015),
    ("decode_ms", 0.01),
    ("fam_window_roofline", 50.0),
    ("edt_row_roofline", 100.0 * 4.224e6 / 33.4e12 / 5e-6),
    ("idle_share", 25.0),
    ("step_mfu", 2.0),
])
def test_reader_on_a_canned_record(name, want):
    module = harness.load_module(REPO / "mattebench/metrics" / f"{name}.py",
                                 "reader_" + name)
    assert module.read(canned_record()) == pytest.approx(want, rel=1e-9)


def test_readers_find_nothing_without_a_profile():
    record = canned_record()
    del record["profile"], record["rate_outside"]
    for name in ("encode_ms", "decode_ms", "fam_window_roofline",
                 "edt_row_roofline", "group_norm_roofline", "idle_share",
                 "step_mfu"):
        module = harness.load_module(REPO / "mattebench/metrics" / f"{name}.py",
                                     "reader_" + name)
        assert module.read(record) is None


def test_group_norm_roofline_reads_its_kernels_only():
    """The program's statistics and apply kernels (4 + 6 us) against a
    bound of 5 us; PyTorch's own GroupNorm kernels are not counted."""
    record = {"profile": {
        "ops": [["void (anonymous namespace)::group_norm_stats<bf16>", 0.0,
                 4.0, 1],
                ["void (anonymous namespace)::group_norm_apply<bf16, 1>", 4.0,
                 6.0, 2],
                ["void at::native::RowwiseMomentsCUDAKernel<float>", 10.0,
                 9.0, 3]],
        "work": {"group_norm": [3.35e12 * 5e-6, 0.0, 33.4e12]}}}
    module = harness.load_module(REPO / "mattebench/metrics/group_norm_roofline.py",
                                 "reader_group_norm_roofline")
    assert module.read(record) == pytest.approx(50.0, rel=1e-9)
    del record["profile"]["work"]["group_norm"]
    assert module.read(record) is None


def test_breakdown_labels_gaps_by_host_span():
    from mattebench import trace
    prof = canned_record()["profile"]
    assert trace.labelled_gaps(prof) == [["wait", 10e-6], ["other", 5e-6]]
    top = trace.top_ops(prof, 2)
    assert top == [["sm90_xmma_fprop", 20e-6], ["void fam_window_mma_kernel<bf16>", 10e-6]]


def test_imports_load_no_jax():
    mods = ["mattebench.run"] + [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "mattebench").rglob("*.py")
        if "tests" not in p.parts]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO)
    assert done.returncode == 0, done.stderr
    assert not set(eval(done.stdout)) & {"jax", "jaxlib", "flax", "tcvom_tpu"}


def test_run_refuses_without_a_card(tmp_path):
    done = subprocess.run([sys.executable, "mattebench/run.py", "--workload",
                           "fba_live", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=REPO,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert done.returncode == 2 and done.stdout == ""


def execute(root, cell, seed=2**31 + 101, seconds=2.5):
    return run.execute(root, cell, seed, seconds, False, "cpu",
                       time.perf_counter(), log=lambda line: None)


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    root = make_root(tmp_path)
    (root / "mattebench/metrics/mattes_total.py").write_text(
        "def read(record):\n"
        "    return len(record['mattes']) * record['streams']\n")
    traffic = json.loads((root / "mattebench/traffic/stream_b4.json").read_text())
    traffic["streams"] = 1
    (root / "mattebench/traffic/stream_one.json").write_text(json.dumps(traffic))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "gca_one", "config": "vmn_gca",
                                  "traffic": "stream_one", "chips": 1,
                                  "why": "added by a test"})
    manifest["end_to_end"].append({"name": "mattes_total", "unit": "mattes",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["gca_one"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    result = execute(root, "gca_one")
    assert set(result["metrics"]) == {"mattes_total", "setup_s"}
    assert result["metrics"]["mattes_total"]["value"] >= 1
    assert result["correct"] is True


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_clean_run_is_correct(tiny_root):
    result = execute(tiny_root, "fba_batch4")
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"mattes_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 2 and result["failed"] == 0


def test_clean_run_of_the_live_cell_is_correct(tiny_root):
    result = execute(tiny_root, "fba_live")
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"mattes_per_s.live", "matte_p95_ms",
                                      "setup_s"}
    assert result["metrics"]["mattes_per_s.live"]["value"] > 0


def _stale_state(orig):
    def step(self, state, img, tri):
        new, out = orig(self, state, img, tri)
        steady = state is not None and state[0] != "first"
        return (state if steady else new), out
    return step


def _half_batch(orig):
    def decode(self, prev, cur, nxt):
        out = orig(self, prev, cur, nxt).clone()
        half = out.shape[0] // 2
        out[half:] = out[:half]
        return out
    return decode


def _altered(orig):
    def decode(self, prev, cur, nxt):
        out = orig(self, prev, cur, nxt).clone()
        out[0] = 255 - out[0]
        return out
    return decode


def _known_altered(orig):
    def decode(self, prev, cur, nxt):
        out = orig(self, prev, cur, nxt).clone()
        out[:, 0, 0] = 7
        return out
    return decode


@pytest.mark.parametrize("method, fault", [
    ("step", _stale_state), ("decode", _half_batch), ("decode", _altered),
    ("decode", _known_altered)])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, method,
                                            fault):
    from tcvom_tpu_torch.infer.predict import StreamingPredictor
    orig = getattr(StreamingPredictor, method)
    monkeypatch.setattr(StreamingPredictor, method, fault(orig))
    result = execute(tiny_root, "fba_batch4")
    assert result["correct"] is False
    assert result["failed"] >= 1


def _residual_conv_perturbed(orig):
    """The program built, then one residual branch's second conv (deep in
    GCA's encoder) given its weight plus noise of a tenth of its scale."""
    def build(config, state_dict, dtype, device):
        sp = orig(config, state_dict, dtype, device)
        w = dict(sp.model.named_parameters())[
            "encoder.layer3.1.conv2.module.weight_bar"]
        gen = torch.Generator(device=w.device).manual_seed(0)
        with torch.no_grad():
            w.add_(0.1 * w.std() * torch.randn(w.shape, generator=gen,
                                               device=w.device, dtype=w.dtype))
        return sp
    return build


def _attention_product_scaled(orig):
    """The guided contextual attention's products 1 % off."""
    def bmm(a, b):
        return orig(a, b) * 1.01
    return bmm


@pytest.mark.parametrize("target, fault", [
    ("mattebench.harness.build_program", _residual_conv_perturbed),
    ("tcvom_tpu_torch.ops.gca_attention._bmm_f32", _attention_product_scaled)])
def test_gca_layers_the_matte_hides_nothing_of(tiny_root, monkeypatch, target,
                                               fault):
    """GCA's deep residual branches and its attention core each move the
    matte past the limit when they go wrong a little."""
    import importlib
    module, name = target.rsplit(".", 1)
    owner = importlib.import_module(module)
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    result = execute(tiny_root, "gca_batch8")
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1
