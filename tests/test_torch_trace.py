"""The port's spans (``tcvom_tpu_torch/utils/trace.py``) on the CPU: off
without a profiler (``record_function`` never called), and under
``torch.profiler`` nested as the streaming matte path and the wild-folder
pipeline open them. FBA at one block a stage and GCA, 64 x 64."""
import json

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from tcvom_tpu_torch.infer import predict as TP
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.tools.make_fake_dataset import make_wild_folder
from tcvom_tpu_torch.utils import trace

H = W = 64
LAYERS = (1, 1, 1, 1)
STATS = {"frames", "prod_read", "prod_upload", "main_qget", "main_step",
         "main_wqput", "writer_fetch", "writer_imwrite"}


def _encode(name):
    gca = [("gca_attention", [])] if name == "vmn_gca" else []
    return ("encode", [("preprocess", []), ("encoder", gca), ("extract", gca),
                       ("qkv", [])])


DECODE = ("decode", [("fam", []), ("head", []), ("paste", [])])


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def predictors():
    out = {}
    for name in ("vmn_fba", "vmn_gca"):
        model = build_model(name, layers=LAYERS, device="cpu")
        out[name] = TP.StreamingPredictor(
            model, TaskConfig(model=name, agg_window=7), fgbg=False,
            quantize=True, device="cpu")
    return out


def _frames(n: int = 2):
    rng = np.random.RandomState(3)
    for i in range(n):
        img = torch.from_numpy(rng.randint(0, 256, (1, H, W, 3), np.uint8))
        tri = torch.zeros((1, H, W, 1), dtype=torch.uint8)
        tri[:, 14 + i:50 + i, 10:54] = 128
        tri[:, 26 + i:38 + i, 24:40] = 255
        yield img, tri


def _step_step_flush(sp):
    state = None
    for img, tri in _frames():
        state, out = sp.step(state, img, tri)
    return out, sp.flush(state)


def _spans(path) -> list[dict]:
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(trace.PREFIX)]


def _forest(spans: list[dict]) -> list:
    """The spans of one thread as nested ``(name, children)`` pairs (the
    prefix dropped), each child inside its parent's interval."""
    roots: list = []
    stack: list = []
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        while stack and e["ts"] >= stack[-1][0]:
            stack.pop()
        node = (e["name"][len(trace.PREFIX):], [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((e["ts"] + e["dur"], node))
    return roots


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_gca"])
def test_spans_are_off_without_a_profiler(predictors, monkeypatch, name):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("step") is trace.span("encode")
    with trace.span("step"):
        pass
    out, last = _step_step_flush(predictors[name])
    assert out.shape == last.shape == (1, H, W)


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_gca"])
def test_a_profiled_step_nests_its_spans(predictors, tmp_path, name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, last = _step_step_flush(predictors[name])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    enc = _encode(name)
    assert _forest(_spans(path)) == [
        ("step", [enc]), ("step", [enc, DECODE]), ("flush", [DECODE])]
    assert trace.span("step") is trace.span("flush")        # off again


@pytest.mark.parametrize("name", ["vmn_fba", "fba"])
def test_folder_phases_are_spans(tmp_path, name):
    """Every phase ``predict_test_folder`` times is a span of its own
    thread; the stats keep their keys."""
    src = tmp_path / "wild"
    make_wild_folder(str(src), frames=3, hw=(60, 90))
    model = build_model(name, agg_window=3, layers=LAYERS, device="cpu")
    cfg = TaskConfig(model=name, agg_window=3)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        stats = TP.predict_test_folder(model, cfg, str(src),
                                       str(tmp_path / "out"), device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    want = STATS if name == "vmn_fba" else STATS - {"main_qget",
                                                    "main_wqput"}
    assert set(stats) == want and stats["frames"] == 3
    spans = _spans(path)
    counts = {k: sum(e["name"] == trace.PREFIX + k for e in spans)
              for k in want - {"frames"}}
    assert counts["main_step"] == counts["prod_read"] == 3
    assert counts["writer_imwrite"] == 3 and min(counts.values()) >= 3
    if name == "vmn_fba":
        # the main thread: each step inside its phase, the flush on its own
        tid = next(e["tid"] for e in spans
                   if e["name"] == trace.PREFIX + "main_step")
        main = _forest([e for e in spans if e["tid"] == tid])
        steps = [kids for n, kids in main if n == "main_step"]
        assert len(steps) == 3 and all(k[0][0] == "step" for k in steps)
        assert ("flush", [DECODE]) in main
