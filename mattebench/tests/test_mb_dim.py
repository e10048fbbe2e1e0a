"""``vmn_dim`` in the benchmark: its plain reference (``reference/dim.py``)
against the program's plain path, the faults in the pool and unpool that
the check must see, the control against the configuration's limits, and
the counts of its work."""
from __future__ import annotations

import json

import pytest
import torch

from mattebench import check, counts, harness, reference, weights
from mattebench.kernels import argmax_pool
from mattebench.tests.test_mb_reference import F64, program
from mattebench.tests.tiny import F32_LIMITS, REPO, TRIMAP
from mattebench.traffic import closed_stream
from tcvom_tpu_torch.ops import argmax_pool_kernel as AK

CONFIG = json.loads((REPO / "mattebench/configs/vmn_dim.json").read_text())


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def traffic(streams: int, height: int, width: int, seed: int = 7,
            dtype: str = "float32", trimap=TRIMAP):
    return closed_stream.make(
        {"streams": streams, "height": height, "width": width, "dtype": dtype,
         "clip_frames": 5, "pool_frames": 4, "inflight": 2, "trimap": trimap},
        seed, "cpu")


def test_spec_is_the_programs():
    from tcvom_tpu_torch.models.registry import build_model

    model = build_model("vmn_dim", agg_window=CONFIG["agg_window"],
                        device="cpu")
    assert reference.spec(CONFIG) == {k: tuple(v.shape) for k, v in
                                      model.state_dict().items()}


@pytest.mark.parametrize("width", [64, 96])
def test_reference_matches_the_program_in_f64(width):
    """The same state dict and frames, f64 on the CPU: the FAM output and
    the alpha within 1e-9, the uint8 mattes of a 3-frame stream within a
    level, most of the unknown pixels strictly between 0 and 255."""
    tp = traffic(2, 64, width)
    sd = weights.make_state_dict(CONFIG, 2**31 + 17, "cpu", tp.batch(0))
    sp = program("vmn_dim", CONFIG, sd, torch.float64, False, "cpu")
    spq = program("vmn_dim", CONFIG, sd, torch.float64, True, "cpu")
    ref = reference.Reference(CONFIG, {k: v.double() if v.is_floating_point()
                                       else v for k, v in sd.items()}, F64)
    frames = [tp.batch(i) for i in range(3)]
    got = [sp.encode(*f) for f in frames]
    want = [ref.encode(*f) for f in frames]

    agg = sp.model.fam.aggregate(got[1]["q"], got[1]["v"], got[0]["k"],
                                 got[2]["k"], got[1]["trimask"])[0]
    agg_ref = ref.aggregate(*want)
    assert torch.allclose(agg, agg_ref, rtol=1e-9,
                          atol=1e-9 * agg_ref.abs().max())

    alpha = sp.decode(*got)[..., 0]
    tri = frames[1][1][..., 0]
    unknown = (tri > 0) & (tri < 255)
    alpha_ref = ref.alpha(*want)[:, 0]
    assert torch.allclose(alpha[unknown], alpha_ref[unknown], rtol=0,
                          atol=1e-9)
    assert torch.equal(alpha[~unknown], tri[~unknown].double() / 255.0)

    mattes = spq.decode(*(spq.encode(*f) for f in frames))
    mattes_ref = ref.matte(*want)
    assert mattes.dtype == torch.uint8 and mattes.shape == mattes_ref.shape
    assert int((mattes.int() - mattes_ref.int()).abs().max()) <= 1
    live = mattes_ref[unknown]
    assert ((live > 0) & (live < 255)).float().mean() > 0.5


def _last_max(x, pool=AK.max_pool_argmax_2x2_ref):
    """The pool with its ties broken the other way: the last max."""
    y, idx = pool(x.flip(-1, -2))
    return y.flip(-1, -2), (3 - idx).flip(-1, -2)


def _slot_shifted(x, idx, unpool=AK.max_unpool_2x2_ref):
    """The unpool writing each value one slot further on."""
    return unpool(x, (idx + 1) % 4)


def _flat_frames(tp) -> None:
    """Each stream's frames one flat colour: every 2x2 window away from
    the trimap's edges holds four equal values, so the tie rule decides
    every index there."""
    colours = torch.tensor([[40, 120, 200], [180, 90, 30]], dtype=torch.uint8)
    for s in range(tp.streams):
        tp.frames[:, s] = colours[s % 2]


@pytest.mark.parametrize("fault", [None, "last_max", "slot_shifted"])
def test_faults_in_the_pool_and_unpool_are_not_correct(monkeypatch, fault):
    """The program's f32 stream on the CPU against the f32 reference, the
    same arithmetic, under the limits of f32 (a tiny checkout's), on flat
    frames: clean it is correct; with the pool's ties broken to the last
    max, or the unpool writing each value one slot on, it is not."""
    tp = traffic(2, 64, 64, seed=2**31 + 9)
    sd = weights.make_state_dict(CONFIG, 2**31 + 9, "cpu", tp.batch(0))
    _flat_frames(tp)
    if fault == "last_max":
        monkeypatch.setattr(AK, "max_pool_argmax_2x2_ref", _last_max)
    elif fault == "slot_shifted":
        monkeypatch.setattr(AK, "max_unpool_2x2_ref", _slot_shifted)
    sp = program("vmn_dim", CONFIG, sd, None, True, "cpu")
    encs = [sp.encode(*tp.batch(i)) for i in range(4)]
    samples = [check.Sample(f, 4, sp.decode(*encs[f - 1:f + 2]))
               for f in (1, 2)]
    monkeypatch.undo()
    want = check.reference_mattes(CONFIG, sd, tp, samples, "cpu")
    result = check.compare(samples, want, tp, F32_LIMITS)
    assert check.passed(result["checks"], result["mattes"]) is (
        fault is None), result["numbers"]


def test_the_control_fails_the_limits():
    """The reference in bf16 with fp8 operands in the program's place
    fails ``vmn_dim``'s bf16 limits; the f32 reference itself passes."""
    limits = CONFIG["limits"]["bfloat16"]
    tp = traffic(2, 256, 256, seed=2**31 + 3, dtype="bfloat16", trimap={
        "unknown": [48, 208, 32, 224], "foreground": [96, 160, 80, 176],
        "shift": 16})
    sd = weights.make_state_dict(CONFIG, 2**31 + 3, "cpu", tp.batch(0))
    samples = [check.Sample(f, 4, None) for f in (0, 2)]
    want = check.reference_mattes(CONFIG, sd, tp, samples, "cpu")
    ctl = check.reference_mattes(CONFIG, sd, tp, samples, "cpu",
                                 reference.FP8)
    result = check.compare([check.Sample(s.clip_frame, s.last, m)
                            for s, m in zip(samples, ctl)], want, tp, limits)
    assert not check.passed(result["checks"], result["mattes"]), result
    same = check.compare([check.Sample(s.clip_frame, s.last, m)
                          for s, m in zip(samples, want)], want, tp, limits)
    assert check.passed(same["checks"], same["mattes"])


def _counted(streams: int = 1):
    prog = object.__new__(harness.Program)
    params = json.loads(
        (REPO / "mattebench/traffic/stream_b4.json").read_text())
    params.update(streams=streams)
    prog.config, prog.params = CONFIG, params
    prog.traffic = type("Shape", (), dict(
        streams=streams, height=1088, width=1920, dtype=torch.bfloat16))
    return prog


def test_argmax_pool_bytes_at_the_cell():
    """Five pools and two unpools an encode, three unpools a head, at
    1088 x 1920 in bf16: 2.75 bytes an element of each larger side."""
    levels = [64 * 1088 * 1920, 128 * 544 * 960, 256 * 272 * 480,
              512 * 136 * 240, 512 * 68 * 120]
    enc = 2.75 * (sum(levels) + levels[4] + levels[3])
    head = 2.75 * (levels[2] + levels[1] + levels[0])
    assert (enc, head) == (758292480.0, 643399680.0)
    assert argmax_pool.per_frame(CONFIG, 1088, 1920, torch.bfloat16) == (
        enc, head)
    assert argmax_pool.work(_counted(4), 3, [0, 1]) == [
        4 * (3 * enc + 2 * head), 0.0, counts.PEAK_F32_ADD_MIN]
    bound_ms = 1e3 * counts.bound_s(enc + head, 0.0, counts.PEAK_F32_ADD_MIN)
    assert round(bound_ms, 3) == 0.418


def test_flop_per_frame_is_pinned():
    assert counts.flop_per_frame(CONFIG, 1088, 1920) == (
        2144442777600.0, 862322688000.0)


def test_argmax_pool_roofline_reads_its_kernels_only():
    from mattebench.lookup import load_module

    reader = load_module(REPO / "mattebench/metrics/argmax_pool_roofline.py",
                         "argmax_pool_roofline_test")
    work = [3.35e9, 0.0, counts.PEAK_F32_ADD_MIN]     # 1 ms at the bound
    record = {"profile": {"ops": [
        ["void argmax_pool_fwd<__nv_bfloat16, 4>(...)", 0.0, 1500.0, 1],
        ["void argmax_pool_unpool<__nv_bfloat16, 4>(...)", 2000.0, 500.0, 1],
        ["void at::native::max_pool_kernel(...)", 3000.0, 9000.0, 1]],
        "work": {"argmax_pool": work}}}
    assert reader.read(record) == pytest.approx(50.0, rel=1e-12)
    assert reader.read({"profile": {"ops": [], "work": {}}}) is None
