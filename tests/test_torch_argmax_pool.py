"""DIM's 2x2 argmax pool and unpool (``ops/image.py``,
``ops/argmax_pool_kernel.py``, ``csrc/argmax_pool.cu``).

On the CPU: where the kernels cannot run the plain ops run, and where they
can every pool and unpool of a DIM stream step calls them; the plain pool
and unpool equal ``F.max_pool2d`` and ``F.max_unpool2d``; the kernels'
vector width; DIM's spans. The ``cuda`` tests hold the kernels bit for bit
against the plain ops on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_argmax_pool.py``); without a card they skip.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from tcvom_tpu_torch.infer.predict import StreamingPredictor
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.ops import argmax_pool_kernel as AK
from tcvom_tpu_torch.ops import cuda_build
from tcvom_tpu_torch.ops.image import max_pool_argmax_2x2, max_unpool_2x2
from tcvom_tpu_torch.parallel import space

# DIM's five pools at 1088 x 1920: (channels, H, W) of each pool's input
DIM_LEVELS = ((64, 1088, 1920), (128, 544, 960), (256, 272, 480),
              (512, 136, 240), (512, 68, 120))


def _refuse(*args, **kwargs):
    raise AssertionError("a CUDA kernel was called")


def _tied(shape, seed=0, dtype=torch.float32, device="cpu"):
    """Values from {0, 1, 2}, so that every pattern of ties fills some
    2x2 windows, in the first half; normal values in the second."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 3, shape, generator=g, device=device).to(dtype)
    half = shape[0] * shape[1] // 2
    flat = x.view(-1, *shape[2:])
    flat[half:] = torch.randn(flat[half:].shape, generator=g,
                              device=device).to(dtype)
    return x


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- the CPU ------------------------------------------------------------------


def test_plain_ops_are_torch_pool_and_unpool():
    """The plain pool's values and in-window index are ``F.max_pool2d``'s
    values and flat index (the first max on ties), and the unpool is
    ``F.max_unpool2d``, on tied and untied windows."""
    x = _tied((2, 6, 10, 14), seed=1)
    got, idx = AK.max_pool_argmax_2x2_ref(x)
    want, flat = F.max_pool2d(x, 2, 2, return_indices=True)
    assert torch.equal(got, want)
    w = x.shape[-1]
    rows = torch.arange(5).view(5, 1) * 2
    cols = torch.arange(7).view(1, 7) * 2
    corner = rows * w + cols
    dy, dx = (flat - corner) // w, (flat - corner) % w
    assert torch.equal(idx.long(), 2 * dy + dx)
    assert set(idx.unique().tolist()) == {0, 1, 2, 3}
    assert torch.equal(AK.max_unpool_2x2_ref(got, idx),
                       F.max_unpool2d(want, flat, 2, 2,
                                      output_size=x.shape[-2:]))


@pytest.mark.parametrize("where", ["cpu", "grad", "meta"])
def test_plain_path_where_the_kernels_cannot_run(monkeypatch, where):
    """On the CPU, under a gradient and on the meta device (a FLOP count)
    the pool and unpool run the plain ops (the kernels' wrappers, patched
    to raise, are never called) and, under a gradient, pass it back."""
    monkeypatch.setattr(AK, "argmax_pool_cuda", _refuse)
    monkeypatch.setattr(AK, "argmax_unpool_cuda", _refuse)
    if where == "meta":
        y, idx = max_pool_argmax_2x2(torch.empty(2, 3, 8, 12, device="meta"))
        out = max_unpool_2x2(y, idx)
        assert (y.shape, idx.dtype, out.shape) == (
            (2, 3, 4, 6), torch.uint8, (2, 3, 8, 12))
        return
    x = _tied((2, 3, 8, 12), seed=2)
    want = AK.max_pool_argmax_2x2_ref(x)
    if where == "grad":
        x.requires_grad_()
    y, idx = max_pool_argmax_2x2(x)
    out = max_unpool_2x2(y, idx)
    assert torch.equal(y, want[0]) and torch.equal(idx, want[1])
    assert torch.equal(out, AK.max_unpool_2x2_ref(*want))
    if where == "grad":
        out.sum().backward()
        # each window passes its gradient to its max (split between tied
        # maxima, as torch.maximum's backward does) and none elsewhere
        assert x.grad.sum().item() == y.numel()
        window_max = F.interpolate(want[0], scale_factor=2, mode="nearest")
        assert not x.grad[x.detach() < window_max].any()


def _recording(calls):
    def pool(x):
        calls.append(("pool", x.dtype, tuple(x.shape)))
        return AK.max_pool_argmax_2x2_ref(x)

    def unpool(x, idx):
        calls.append(("unpool", x.dtype, tuple(x.shape)))
        return AK.max_unpool_2x2_ref(x, idx)

    return pool, unpool


@pytest.mark.parametrize("banded", [False, True])
def test_the_kernels_run_where_they_can(monkeypatch, banded):
    """Where a tensor is on the card and needs no gradient (said so here by
    ``runs_plain``), the pool and unpool call the kernels' wrappers, in
    band mode too (both stay within the band, which ``_local`` checks)."""
    calls = []
    pool, unpool = _recording(calls)
    monkeypatch.setattr(AK, "runs_plain", lambda *a: False)
    monkeypatch.setattr(AK, "argmax_pool_cuda", pool)
    monkeypatch.setattr(AK, "argmax_unpool_cuda", unpool)
    x = _tied((1, 2, 32, 6), seed=3)
    with space.banded(space.Bands(32)) if banded else \
            contextlib.nullcontext():
        y, idx = max_pool_argmax_2x2(x)
        max_unpool_2x2(y, idx)
    assert calls == [("pool", torch.float32, (1, 2, 32, 6)),
                     ("unpool", torch.float32, (1, 2, 16, 3))]
    if banded:
        with space.banded(space.Bands(32)), pytest.raises(ValueError):
            max_pool_argmax_2x2(x[:, :, :12])    # 12 rows: no band of 32


@pytest.fixture(scope="module")
def dim_model():
    return build_model("vmn_dim", agg_window=3, device="cpu",
                       generator=torch.Generator().manual_seed(4))


def _dim_frames(n: int = 3, h: int = 64, w: int = 96):
    rng = np.random.RandomState(5)
    for i in range(n):
        img = torch.from_numpy(rng.randint(0, 256, (1, h, w, 3), np.uint8))
        tri = torch.zeros((1, h, w, 1), dtype=torch.uint8)
        tri[:, 10 + i:50 + i, 10:80] = 128
        tri[:, 25:35, 30:60] = 255
        yield img, tri


def _stream(sp, frames):
    state, outs = None, []
    for img, tri in frames:
        state, out = sp.step(state, img, tri)
        if out is not None:
            outs.append(out)
    return outs + [sp.flush(state)]


def test_every_pool_and_unpool_of_a_dim_step_calls_the_kernels(
        monkeypatch, dim_model):
    """A ``vmn_dim`` stream of 3 frames (3 encodes, 3 decodes) in bf16 with
    the kernels' dispatch taken: 5 pools an encode, 2 unpools in its
    extract half and 3 in each head, all through the wrappers, and the
    mattes those of the plain run."""
    cfg = TaskConfig(model="vmn_dim", agg_window=3)
    sp = StreamingPredictor(dim_model, cfg, dtype=torch.bfloat16, fgbg=False,
                            quantize=True, device="cpu")
    want = _stream(sp, _dim_frames())
    calls = []
    pool, unpool = _recording(calls)
    monkeypatch.setattr(AK, "runs_plain", lambda *a: False)
    monkeypatch.setattr(AK, "argmax_pool_cuda", pool)
    monkeypatch.setattr(AK, "argmax_unpool_cuda", unpool)
    got = _stream(sp, _dim_frames())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    kinds = [c[0] for c in calls]
    assert kinds.count("pool") == 3 * 5 and kinds.count("unpool") == 3 * 5
    assert {c[1] for c in calls} == {torch.bfloat16}
    # one encode's pools, deepest last, and its extract's two unpools
    assert calls[:7] == [
        ("pool", torch.bfloat16, (1, 64, 64, 96)),
        ("pool", torch.bfloat16, (1, 128, 32, 48)),
        ("pool", torch.bfloat16, (1, 256, 16, 24)),
        ("pool", torch.bfloat16, (1, 512, 8, 12)),
        ("pool", torch.bfloat16, (1, 512, 4, 6)),
        ("unpool", torch.bfloat16, (1, 512, 2, 3)),
        ("unpool", torch.bfloat16, (1, 512, 4, 6))]


def test_dim_spans(dim_model):
    """Under the profiler each pool records ``tcvom.pool`` inside
    ``tcvom.encoder`` and each unpool ``tcvom.unpool``, two inside
    ``tcvom.extract`` and three inside ``tcvom.head``."""
    cfg = TaskConfig(model="vmn_dim", agg_window=3)
    sp = StreamingPredictor(dim_model, cfg, fgbg=False, quantize=True,
                            device="cpu")
    frames = list(_dim_frames(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stream(sp, frames)
    events = [e for e in prof.events() if e.name.startswith("tcvom.")]

    def inside(name, parent):
        return sum(1 for e in events if e.name == name and any(
            p.name == parent and p.time_range.start <= e.time_range.start
            and e.time_range.end <= p.time_range.end for p in events))

    names = [e.name for e in events]
    assert names.count("tcvom.pool") == 2 * 5
    assert names.count("tcvom.unpool") == 2 * 2 + 2 * 3
    assert inside("tcvom.pool", "tcvom.encoder") == 10
    assert inside("tcvom.unpool", "tcvom.extract") == 4
    assert inside("tcvom.unpool", "tcvom.head") == 6


@pytest.mark.parametrize("shape, offset, wide", [
    ((1, 2, 4, 16), 0, True),       # 8 outputs a row, aligned
    ((1, 2, 4, 12), 0, False),      # 6 outputs a row
    ((1, 2, 4, 16), 1, False),      # a view one value off the allocation
])
def test_vector_width(shape, offset, wide):
    """The kernels' wide form where every row of outputs splits into runs
    of 4 and every address allows 16-byte loads, else one value a thread."""
    n = int(np.prod(shape))
    x = torch.zeros(n + 8)[offset:offset + n].view(shape)
    y = torch.zeros(shape[:2] + (shape[2] // 2, shape[3] // 2))
    idx = torch.zeros(y.shape, dtype=torch.uint8)
    assert AK._vec(shape[3] // 2, (x, y, idx), AK.POOL_ALIGN) == (
        AK.WIDE if wide else 1)


def test_the_wrappers_refuse_cpu_tensors():
    """Called by hand on a CPU tensor, the wrappers raise: they never fall
    back to the plain ops."""
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        AK.argmax_pool_cuda(x)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        AK.argmax_unpool_cuda(x, torch.zeros(x.shape, dtype=torch.uint8))


class _Compiler:
    """A stand-in for an ``nvcc`` process that is still running."""
    started: list = []

    def __init__(self, cmd, **kw):
        self.returncode = None
        _Compiler.started.append(self)

    def poll(self):
        return self.returncode

    def communicate(self):
        raise KeyboardInterrupt

    def kill(self):
        self.returncode = -9

    def wait(self):
        return self.returncode


@pytest.mark.parametrize("fault", ["missing_source", "error_while_running"])
def test_build_leaves_no_compiler_running(monkeypatch, tmp_path, fault):
    """A kernel list naming a source the tree lacks raises before any
    ``nvcc`` starts, whatever its place in the list; an error while the
    compilers run kills those started."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", _Compiler)
    monkeypatch.setattr(_Compiler, "started", [])
    if fault == "missing_source":
        with pytest.raises(FileNotFoundError):
            cuda_build.build(["fam_window", "no_such_kernel"])
        assert _Compiler.started == []
    else:
        with pytest.raises(KeyboardInterrupt):
            cuda_build.build(["fam_window", "argmax_pool"])
        assert len(_Compiler.started) == 2
        assert all(p.returncode == -9 for p in _Compiler.started)


# -- the card -----------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _hold(x: torch.Tensor) -> None:
    """The kernels (through the model's dispatch) against the plain ops
    on the same card tensor: pooled values and unpooled output bit for bit
    and in the same memory layout, indices equal, one launch each."""
    cuda_build.LAUNCHES.clear()
    y, idx = max_pool_argmax_2x2(x)
    out = max_unpool_2x2(y, idx)
    torch.cuda.synchronize()
    assert dict(cuda_build.LAUNCHES) == {"argmax_pool_fwd": 1,
                                         "argmax_pool_unpool": 1}
    want_y, want_idx = AK.max_pool_argmax_2x2_ref(x)
    want_out = AK.max_unpool_2x2_ref(want_y, want_idx)
    assert torch.equal(_bits(y), _bits(want_y))
    assert torch.equal(idx, want_idx)
    assert torch.equal(_bits(out), _bits(want_out))
    assert (y.stride(), idx.stride(), out.stride()) == (
        want_y.stride(), want_idx.stride(), want_out.stride())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("level", range(len(DIM_LEVELS)))
def test_kernels_bit_identical_at_dim_levels(dev, level, batch, dtype,
                                             layout):
    """At DIM's five levels of a 1088 x 1920 frame, batch 1 and 4, NCHW
    and channels-last (as DIM's encoder holds them): every tie pattern of
    a window (the first half's values from {0, 1, 2})."""
    x = _tied((batch,) + DIM_LEVELS[level], seed=level, dtype=dtype,
              device=dev)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    _hold(x)
    idx = max_pool_argmax_2x2(x)[1]
    assert set(idx.unique().tolist()) == {0, 1, 2, 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_planted_ties_and_odd_shapes(dev, dtype):
    """Each of the 15 sets of window positions holding the max (the rest
    lower), NaN and signed zeros, at widths and views that take the
    one-value-a-thread form: 6 and 10 columns, a view one value off its
    allocation, 6 channels channels-last; a strided input of neither
    layout made contiguous."""
    sets = [[p for p in range(4) if m >> p & 1] for m in range(1, 16)]
    x = torch.zeros(1, len(sets), 2, 2, dtype=dtype)
    for i, s in enumerate(sets):
        x[0, i].view(-1)[:] = -1.0
        x[0, i].view(-1)[s] = 3.0
    y, idx = AK.max_pool_argmax_2x2_ref(x)
    assert idx.view(-1).tolist() == [s[0] for s in sets]
    _hold(x.to(dev))
    special = torch.tensor([[[[float("nan"), 1.0], [2.0, 0.0]],
                             [[-0.0, 0.0], [-1.0, -0.0]]]], dtype=dtype)
    _hold(special.to(dev))
    for shape in ((2, 3, 6, 6), (1, 4, 8, 10)):
        _hold(_tied(shape, seed=7, dtype=dtype, device=dev))
    n = 2 * 8 * 16 * 16
    flat = torch.randn(n + 1, device=dev).to(dtype)
    _hold(flat[1:].view(2, 8, 16, 16))
    cl = _tied((2, 6, 32, 40), seed=8, dtype=dtype, device=dev).to(
        memory_format=torch.channels_last)
    assert not cl.is_contiguous()
    _hold(cl)
    strided = _tied((2, 8, 32, 80), seed=10, dtype=dtype, device=dev)
    _hold(strided[..., ::2])


@pytest.mark.cuda
def test_plain_path_under_autograd_on_card(dev):
    """A tensor that needs a gradient takes the plain ops on the card (no
    launch), whose backward runs; the wrappers refuse it."""
    x = _tied((2, 4, 16, 16), seed=9, device=dev).requires_grad_()
    cuda_build.LAUNCHES.clear()
    y, idx = max_pool_argmax_2x2(x)
    max_unpool_2x2(y, idx).sum().backward()
    assert sum(cuda_build.LAUNCHES.values()) == 0
    assert x.grad is not None and x.grad.sum().item() == y.numel()
    with pytest.raises(ValueError, match="gradient"):
        AK.argmax_pool_cuda(x)
    with pytest.raises(ValueError, match="gradient"):
        AK.argmax_unpool_cuda(y, idx)


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take(dev):
    """f64, odd sizes and a wrong index raise; nothing is launched."""
    cuda_build.LAUNCHES.clear()
    x = torch.zeros(1, 2, 4, 4, device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        max_pool_argmax_2x2(x.double())
    with pytest.raises(ValueError, match="f32 or bf16"):
        max_unpool_2x2(x.double(), torch.zeros(x.shape, dtype=torch.uint8,
                                               device=dev))
    with pytest.raises(ValueError, match="even H and W"):
        AK.argmax_pool_cuda(x[..., :3])
    with pytest.raises(ValueError, match="uint8 index"):
        max_unpool_2x2(x, torch.zeros(x.shape, dtype=torch.int64, device=dev))
    assert sum(cuda_build.LAUNCHES.values()) == 0
