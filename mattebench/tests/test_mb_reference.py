"""The frozen reference against the program's plain path, on the same
state dict and frames: at 64 x 64 on the CPU (FBA one block a stage), in
f64, where both are the same arithmetic; the mattes, the alpha before
them and FAM's output. The ``cuda`` test holds them on the card."""
from __future__ import annotations

import json

import pytest
import torch

from mattebench import reference, weights
from mattebench.tests.tiny import REPO, TRIMAP
from mattebench.traffic import closed_stream

F64 = reference.Arith(torch.float64)


def config(name: str) -> dict:
    cfg = json.loads((REPO / "mattebench" / "configs" / f"{name}.json").read_text())
    if "layers" in cfg:
        cfg["layers"] = [1, 1, 1, 1]
    return cfg


def traffic(streams: int, size: int = 64, device="cpu"):
    return closed_stream.make(
        {"streams": streams, "height": size, "width": size, "dtype": "float32",
         "clip_frames": 5, "pool_frames": 4, "inflight": 2, "trimap": TRIMAP},
        7, device)


def program(name: str, cfg: dict, sd: dict, dtype, quantize: bool, device):
    from tcvom_tpu_torch.infer.predict import StreamingPredictor
    from tcvom_tpu_torch.models.full_model import TaskConfig
    from tcvom_tpu_torch.models.registry import build_model

    kw = {"layers": tuple(cfg["layers"])} if "layers" in cfg else {}
    model = build_model(name, agg_window=cfg["agg_window"], device=device, **kw)
    model.load_state_dict(sd, strict=True)
    return StreamingPredictor(model, TaskConfig(model=name, agg_window=7),
                              dtype=dtype, fgbg=False, quantize=quantize,
                              device=device)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_gca"])
def test_reference_matches_the_program_in_f64(name):
    cfg = config(name)
    tp = traffic(2)
    sd = weights.make_state_dict(cfg, 2**31 + 17, "cpu", tp.batch(0))
    sp = program(name, cfg, sd, torch.float64, False, "cpu")
    spq = program(name, cfg, sd, torch.float64, True, "cpu")
    ref = reference.Reference(cfg, {k: v.double() if v.is_floating_point() else v
                                    for k, v in sd.items()}, F64)
    frames = [tp.batch(i) for i in range(3)]
    got = [sp.encode(*f) for f in frames]
    want = [ref.encode(*f) for f in frames]

    agg = sp.model.fam.aggregate(got[1]["q"], got[1]["v"], got[0]["k"],
                                 got[2]["k"], got[1]["trimask"])[0]
    agg_ref = ref.aggregate(*want)
    assert torch.allclose(agg, agg_ref, rtol=1e-9, atol=1e-9 * agg_ref.abs().max())

    alpha = sp.decode(*got)[..., 0]                       # pasted, [N, H, W]
    tri = frames[1][1][..., 0]
    unknown = (tri > 0) & (tri < 255)
    alpha_ref = ref.alpha(*want)[:, 0]
    assert torch.allclose(alpha[unknown], alpha_ref[unknown], rtol=0, atol=1e-9)
    assert torch.equal(alpha[~unknown], tri[~unknown].double() / 255.0)

    mattes = spq.decode(*(spq.encode(*f) for f in frames))
    mattes_ref = ref.matte(*want)
    assert mattes.dtype == torch.uint8 and mattes.shape == mattes_ref.shape
    assert int((mattes.int() - mattes_ref.int()).abs().max()) <= 1
    live = mattes_ref[unknown]
    assert ((live > 0) & (live < 255)).float().mean() > 0.01


def test_fba_encoding_distance_is_exact():
    """The reference's EDT against a brute-force distance."""
    g = torch.Generator().manual_seed(3)
    seed = torch.rand((2, 19, 23), generator=g) > 0.93
    seed[1] = False
    seed[1, 4, 20] = True
    got = reference.common.edt_squared(seed)
    ys, xs = torch.meshgrid(torch.arange(19), torch.arange(23), indexing="ij")
    for b in range(2):
        pts = seed[b].nonzero().float()
        grid = torch.stack([ys, xs], -1).reshape(-1, 1, 2).float()
        want = ((grid - pts[None]) ** 2).sum(-1).min(-1).values.reshape(19, 23)
        assert torch.equal(got[b], want)
    assert torch.isinf(reference.common.edt_squared(
        torch.zeros((3, 4), dtype=torch.bool))).all()


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys, mattebench.reference, mattebench.reference.fba, "
            "mattebench.reference.gca, mattebench.reference.common\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"tcvom_tpu_torch", "tcvom_tpu", "jax", "jaxlib", "flax"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vmn_fba", "vmn_gca"])
def test_reference_matches_the_program_on_the_card(card, name):
    """f32 program (its kernels) against the f32 reference at 256 x 256,
    TF32 off on both sides: within one level, the known pixels exact."""
    cfg = json.loads((REPO / "mattebench" / "configs" / f"{name}.json").read_text())
    tp = closed_stream.make(
        {"streams": 2, "height": 256, "width": 256, "dtype": "float32",
         "clip_frames": 5, "pool_frames": 4, "inflight": 2,
         "trimap": {"unknown": [40, 200, 30, 220], "foreground": [90, 150,
                                                                   80, 170],
                    "shift": 8}}, 5, card)
    sd = weights.make_state_dict(cfg, 5, card, tp.batch(0))
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sp = program(name, cfg, sd, None, True, card)
        ref = reference.Reference(cfg, sd)
        frames = [tuple(t.to(card) for t in tp.batch(i)) for i in range(3)]
        with torch.no_grad():
            got = sp.decode(*(sp.encode(*f) for f in frames))
            want = ref.matte(*(ref.encode(*f) for f in frames))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    diff = (got.int() - want.int()).abs()
    tri = frames[1][1][..., 0]
    known = (tri == 0) | (tri == 255)
    assert int(diff.max()) <= 1
    assert int(diff[known].max()) == 0
