"""The port's flow resampling (``data/vmd.py::flow_crop_and_resize``)
against the JAX package's, on the CPU: equal arrays, NaN where NaN, on
random flows that hit every rule of the consistency check and of the
out-of-frame mask."""
import numpy as np
import pytest

from tcvom_tpu.data import vmd as JV
from tcvom_tpu_torch.data import vmd as TV


def _flow(seed: int, h: int = 37, w: int = 53) -> np.ndarray:
    """A smooth field that points out of the frame near its edges, with
    NaN pixels, +-60-pixel jumps (the magnitude check), perpendicular
    neighbours (the angle check), near-parallel ones (just inside it),
    short and zero vectors (exempt from it)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    flow = np.stack([(xx - w / 2) * 0.6, (yy - h / 2) * 0.5], -1)
    flow += rng.uniform(-0.5, 0.5, flow.shape).astype(np.float32)
    jumps = rng.rand(h, w) < 0.04
    flow[jumps] += rng.choice([-60.0, 60.0], (jumps.sum(), 2))
    turn = rng.rand(h, w) < 0.05                  # rotated by 90 degrees
    flow[turn] = flow[turn][:, ::-1] * np.float32([-1, 1])
    par = np.nonzero(rng.rand(h - 1, w) < 0.03)   # its lower neighbour, ~0.1°
    flow[par[0] + 1, par[1]] = flow[par] * 1.3 + flow[par][:, ::-1] * \
        np.float32([-2e-3, 2e-3])
    flow[rng.rand(h, w) < 0.03] = rng.uniform(-0.6, 0.6, 2)
    flow[rng.rand(h, w) < 0.02] = 0.0
    flow[rng.rand(h, w) < 0.05] = np.nan
    return flow.astype(np.float32)


@pytest.mark.parametrize("crop,out", [
    ((3, 5, (30, 41)), (24, 24)),       # a training crop, shrunk
    ((0, 2, (20, 20)), (32, 32)),       # a training crop, enlarged
    ((0, 0, None), (40, 64)),           # the val resize path
    ((0, 0, None), (37, 53)),           # the val resize path at its size
])
def test_flow_crop_and_resize_matches_jax(crop, out):
    flow = _flow(sum(out))
    want = JV.flow_crop_and_resize(flow.copy(), *crop, list(out))
    got = TV.flow_crop_and_resize(flow.copy(), *crop, list(out))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == out + (2,)
    np.testing.assert_array_equal(got, want)       # NaN equals NaN
    nan = np.isnan(want[..., 0])
    # every rule left valid pixels and made invalid ones
    assert 0.05 < nan.mean() < 0.9
