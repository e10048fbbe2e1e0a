"""The port's sampling ops, metrics and metric calculator against the JAX
package's, on the CPU."""
import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tcvom_tpu.ops import image as JI
from tcvom_tpu.ops import metrics as JM
from tcvom_tpu_torch.infer.predict import write_pred_pngs
from tcvom_tpu_torch.ops import image as TI
from tcvom_tpu_torch.ops import metrics as TM
from tcvom_tpu_torch.tools import calc_metric
from tcvom_tpu_torch.tools.make_fake_dataset import make
from tcvom_tpu_torch.utils.imageio import (IMREAD_UNCHANGED, imread,
                                           imwrite)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_coords_grid_matches_jax():
    np.testing.assert_array_equal(TI.coords_grid(5, 7).numpy(),
                                  np.asarray(JI.coords_grid(5, 7)))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(rng, mode):
    """Leading dims, several channels, coordinates well outside the frame
    (out-of-frame corners contribute zero)."""
    img = rng.rand(2, 7, 9, 3).astype(np.float32)
    coords = rng.uniform(-2.5, 11.5, (2, 5, 6, 2)).astype(np.float32)
    coords[0, 0, :3] = [[0, 0], [8, 6], [8.5, 6.5]]       # edges exactly
    want = JI.grid_sample(jnp.asarray(img), jnp.asarray(coords), mode=mode)
    got = TI.grid_sample(torch.from_numpy(img), torch.from_numpy(coords),
                         mode=mode)
    assert got.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _frame_args(seed: int, h=24, w=31):
    rng = np.random.RandomState(seed)
    a, g, ha, hg = (rng.rand(h, w).astype(np.float32) for _ in range(4))
    tri = rng.choice([0.0, 128.0, 255.0], (h, w)).astype(np.float32)
    flow = rng.uniform(-4, 4, (h, w, 2)).astype(np.float32)
    flow[rng.rand(h, w) < 0.2] = np.nan                 # invalid pixels
    flow[3:5, :, 0] = 40.0                              # warps off-frame
    return a, g, tri, ha, hg, flow


@pytest.mark.parametrize("hvalid", [0.0, 1.0])
def test_frame_metrics_matches_jax(hvalid):
    a, g, tri, ha, hg, flow = _frame_args(1)
    args = (a, g, tri, ha, hg, np.float32(hvalid), flow)
    want = JM.frame_metrics(*[jnp.asarray(x) for x in args])
    got = TM.frame_metrics(*[torch.as_tensor(x) for x in args])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(got["MESSDdt"]) > 0 if hvalid else float(got["dtSSD"]) == 0


@pytest.fixture(scope="module")
def pred_tree(tmp_path_factory):
    """A fake VideoMatting108 tree with random predictions for its val clip
    and one flow PNG holding real motion and invalid pixels."""
    root = str(tmp_path_factory.mktemp("vmd"))
    pred = str(tmp_path_factory.mktemp("pred"))
    make(root, frames=4, hw=(32, 48), seed=2)
    rng = np.random.RandomState(3)
    names = [f"clip_b/{i:05d}.png" for i in range(4)]
    write_pred_pngs(pred, names, rng.rand(4, 32, 48, 1),
                    rng.choice([0.0, 0.5, 1.0], (4, 32, 48, 1)),
                    crop_hw=(32, 48))
    path = os.path.join(root, "flow_png", "clip_b", "flow_00001_00002.png")
    x = imread(path, IMREAD_UNCHANGED)
    x[..., :2] = rng.randint(-300, 300, (32, 48, 2)).astype(np.uint16)
    x[..., 2] = np.where(rng.rand(32, 48) < 0.3, 0, 255)
    imwrite(path, x)
    return root, pred


def test_calc_metric_matches_jax_tool(pred_tree, tmp_path, monkeypatch):
    """The port's metric.json against tools/calc_metric.py's on one tree:
    the same keys at every level, the numbers to rtol 1e-5."""
    root, pred = pred_tree
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import calc_metric as jax_tool
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", ["calc_metric", "--pred", pred, "--data",
                                      root, "--output", want_path,
                                      "--n_threads", "2"])
    jax_tool.main()
    got = calc_metric.main(["--pred", pred, "--data", root, "--output",
                            got_path, "--n_threads", "2", "--device", "cpu"])
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        assert json.load(f) == got

    def compare(w, g, where):
        assert isinstance(g, dict) == isinstance(w, dict), where
        if isinstance(w, dict):
            assert set(g) == set(w), where
            for k in w:
                compare(w[k], g[k], f"{where}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=where)

    compare(want, got, "")
    assert list(got["all"]) == ["clip_b"]
    assert len(got["all"]["clip_b"]["all"]) == 4
    assert got["avg"]["MESSDdt"] > 0


def test_calc_metric_needs_a_card_or_an_explicit_cpu(pred_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, pred = pred_tree
    with pytest.raises(RuntimeError, match="CUDA"):
        calc_metric.main(["--pred", pred, "--data", root])
    with pytest.raises(RuntimeError, match="CUDA"):
        calc_metric.main(["--pred", pred, "--data", root, "--vis"])
