"""The port's GroupNorm with its fused activation and residual
(``models/layers.py::GroupNorm``, ``ops/group_norm_kernel.py``) on the CPU:
where the CUDA kernel cannot run, the plain ops run; the fused call is
today's composition of separate ops bit for bit; FBA hands each norm its
activation and residual; the kernel's launch plan. The kernel itself is
tested on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from tcvom_tpu_torch.models.layers import GroupNorm
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.ops import group_norm_kernel as GK
from tcvom_tpu_torch.parallel import space


def _refuse(*args, **kwargs):
    raise AssertionError("the CUDA kernel was called")


def _norm(rng, act=None, groups=4, channels=8):
    gn = GroupNorm(groups, channels, act=act)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(rng.randn(channels)))
        gn.bias.copy_(torch.from_numpy(rng.randn(channels)))
    return gn


def _record(calls):
    def fused(x, groups, weight, bias, eps, act=None, residual=None):
        calls.append((act, residual is not None))
        return GK.group_norm_ref(x, groups, weight, bias, eps, act, residual)
    return fused


@pytest.mark.parametrize("where", ["cpu", "grad", "band"])
def test_plain_path_where_the_kernel_cannot_run(rng, monkeypatch, where):
    """On the CPU, under a gradient and in band mode the norm runs the
    plain ops: the kernels' wrapper, patched to raise, is never called (in
    band mode even with the tensors said to be where it runs)."""
    monkeypatch.setattr(GK, "group_norm_cuda", _refuse)
    if where == "band":
        monkeypatch.setattr(GK, "runs_plain", lambda *a: False)
    gn = _norm(rng, "relu")
    x = torch.from_numpy(rng.randn(2, 8, 32, 5).astype(np.float32))
    res = torch.from_numpy(rng.randn(2, 8, 32, 5).astype(np.float32))
    want = GK.group_norm_ref(x, 4, gn.weight, gn.bias, gn.eps, "relu", res)
    if where == "band":
        bands = space.Bands(32)
        with torch.no_grad(), space.banded(bands):
            got = gn(x, res)
        assert bands.counts["sum"][0] == 2          # the two-pass statistics
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        return
    if where == "grad":
        x.requires_grad_()
    got = gn(x, res)
    assert torch.equal(got, want)
    assert GK.runs_plain(x, gn.weight, gn.bias, res)
    if where == "grad":
        got.sum().backward()
        assert x.grad is not None and gn.weight.grad is not None


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", list(GK.ACTS))
def test_fused_call_is_the_composition(rng, monkeypatch, act, residual):
    """f32: the fused call (the wrapper's place taken by the plain version)
    and the plain path are today's ops one after the other, bit for bit:
    ``F.group_norm``, the add, then ``F.relu`` or ``nn.LeakyReLU(0.01)``."""
    gn = _norm(rng, act)
    x = torch.from_numpy(rng.randn(3, 8, 6, 7).astype(np.float32) * 3 + 1)
    res = (torch.from_numpy(rng.randn(3, 8, 6, 7).astype(np.float32))
           if residual else None)
    want = F.group_norm(x, 4, gn.weight, gn.bias, 1e-5)
    if residual:
        want = want + res
    want = {None: lambda t: t, "relu": F.relu,
            "leaky_relu": nn.LeakyReLU(0.01)}[act](want)
    calls = []
    with torch.no_grad():
        plain = gn(x, res)
        monkeypatch.setattr(GK, "runs_plain", lambda *a: False)
        monkeypatch.setattr(GK, "group_norm_cuda", _record(calls))
        fused = gn(x, res)
    assert calls == [(act, residual)]
    for got in (plain, fused, GK.group_norm_ref(x, 4, gn.weight, gn.bias,
                                                1e-5, act, res)):
        assert torch.equal(got, want)


def test_fba_hands_each_norm_its_activation_and_residual(rng, monkeypatch):
    """A small vmn_fba forward (one block a stage, 64 x 64, three frames)
    through the fused call equals its plain forward bit for bit, and every
    GroupNorm is called once with the activation that followed it before
    (ReLU in the stem and blocks, after the residual add in each ``bn3``;
    none in ``downsample``; LeakyReLU in the PPM and the decoder)."""
    model = build_model("vmn_fba", agg_window=3, layers=(1, 1, 1, 1),
                        device="cpu").eval()
    t = lambda *shape: torch.from_numpy(rng.rand(*shape).astype(np.float32))
    args = (t(1, 3, 11, 64, 64), torch.ones(1, 3, 1, 64, 64),
            (t(1, 3, 3, 64, 64), (t(1, 3, 2, 64, 64) > 0.5).float()))
    calls = []
    with torch.no_grad():
        plain = model(*args)
        monkeypatch.setattr(GK, "runs_plain", lambda *a: False)
        monkeypatch.setattr(GK, "group_norm_cuda", _record(calls))
        fused = model(*args)
    for p, f in zip(plain, fused):
        assert torch.equal(p, f)
    norms = sum(isinstance(m, GroupNorm) for m in model.modules())
    assert len(calls) == norms == 25
    assert {k: calls.count(k) for k in set(calls)} == {
        ("relu", False): 9, ("relu", True): 4, (None, False): 4,
        ("leaky_relu", False): 8}


def test_plan_fills_the_card_at_batch_1():
    """The statistics blocks of FBA's GroupNorms at 1088 x 1920 in bf16 on
    132 SMs: each reads at least SPLIT_BYTES, and there are several per SM
    at batch 1 unless that floor stops them; the apply blocks read at most
    TILE_BYTES; a PPM grid of one pixel takes one block of each."""
    for n, c, hw in ((1, 2048, 136 * 240), (1, 64, 544 * 960),
                     (4, 1024, 136 * 240), (1, 128, 136 * 240)):
        splits, tiles = GK.plan(n, c, hw, 32, 2, 132)
        per_split = c // 32 * hw * 2 // splits
        assert per_split >= GK.SPLIT_BYTES
        assert n * 32 * splits >= 4 * 132 or per_split < 2 * GK.SPLIT_BYTES
        assert -(-hw * 2 // tiles) <= GK.TILE_BYTES
    assert GK.plan(1, 256, 1, 32, 2, 132) == (1, 1)
