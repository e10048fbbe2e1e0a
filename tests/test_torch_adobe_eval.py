"""The Adobe-DIM evaluation data against the JAX package's, on the CPU:
``DIMEvalDataset`` in every ``val_mode``; and the ``--vis`` images of
``pred_single`` and ``calc_metric`` against the JAX tools' own drawing
(``pred_single --dataset adobe`` runs in ``test_torch_tools.py``)."""
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest

from tcvom_tpu.data import dim as JDim
from tcvom_tpu_torch.data import augment as TAug
from tcvom_tpu_torch.data import dim as TDim
from tcvom_tpu_torch.tools import calc_metric, pred_single
from tcvom_tpu_torch.tools.make_fake_dataset import make, make_adobe
from tcvom_tpu_torch.utils import imageio as IO
from tcvom_tpu_torch.utils import visualize as TVis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def adobe_root(tmp_path_factory):
    """3 stills of 60x44, 68x48 and 76x52, backgrounds twice as large."""
    root = str(tmp_path_factory.mktemp("adobe"))
    make_adobe(root, n=3, hw=(60, 44), seed=5)
    return root


def _assert_items_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("val_mode,min_shape,n", [
    ("gca", 96, 3), ("dim", 128, 3), ("resize", 64, 3), ("origin", 64, 1)])
def test_dim_eval_items_match_jax(adobe_root, tmp_path, val_mode, min_shape,
                                  n):
    """Every still's item (its grid, the padding, the fixed synthesis and
    ``og_shape``); ``origin`` ignores ``min_shape`` (its grid is
    2112x2112), so one still there."""
    root = adobe_root
    if n == 1:
        root = str(tmp_path / "one")
        make_adobe(root, n=1, hw=(60, 44), seed=5)
    kw = dict(data_root=root, val_mode=val_mode, min_shape=min_shape,
              plus1=False)
    want, got = JDim.DIMEvalDataset(**kw), TDim.DIMEvalDataset(**kw)
    assert got.image_shape == want.image_shape and len(got) == n
    for i in range(n):
        item = got[(0, i)]
        assert item["a"].shape == (3,) + want.image_shape + (1,)
        assert item["og_shape"].tolist() == [60 + 8 * i, 44 + 4 * i]
        _assert_items_equal(item, want[i])
        if i == 1:      # the eval items draw nothing: not from the epoch
            np.testing.assert_array_equal(got[(5, i)]["fg"], item["fg"])
        assert ((item["a"] > 0) & (item["a"] < 255)).any()


def test_dim_eval_grid_too_small_raises(adobe_root):
    kw = dict(data_root=adobe_root, val_mode="gca", min_shape=48,
              plus1=False)
    with pytest.raises(ValueError, match="exceeds"):
        JDim.DIMEvalDataset(**kw)[0]
    with pytest.raises(ValueError, match="exceeds"):
        TDim.DIMEvalDataset(**kw)[(0, 0)]
    with pytest.raises(ValueError, match="val_mode"):
        TDim.DIMEvalDataset(data_root=adobe_root, val_mode="crop")


def test_vis_image_is_the_jax_tools(tmp_path):
    """pred_single's captioned image, byte for byte the JAX tool's
    ``write_vis_image`` on the same arrays."""
    spec = importlib.util.spec_from_file_location(
        "jax_pred_single", os.path.join(ROOT, "tools", "pred_single.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    rng = np.random.RandomState(2)
    a8, g8 = (rng.randint(0, 256, (70, 90), np.uint8) for _ in range(2))
    t8 = rng.choice([0, 128, 255], (70, 90)).astype(np.uint8)
    jax_tool.write_vis_image(str(tmp_path / "jax"), "clip/00003", a8, g8, t8,
                             0.0123456789, 0.00042, 1234)
    TVis.write_vis_image(str(tmp_path / "port"), "clip/00003.png", a8, g8,
                         t8, 0.0123456789, 0.00042, 1234)
    with open(tmp_path / "jax" / "clip" / "00003.png", "rb") as f:
        want = f.read()
    with open(tmp_path / "port" / "clip" / "00003.png", "rb") as f:
        assert f.read() == want
    assert cv2.imread(str(tmp_path / "port" / "clip" / "00003.png")).shape \
        == (170, 180, 3)


@pytest.fixture(scope="module")
def pred_tree(tmp_path_factory):
    """A VideoMatting108 tree and random predictions for its val clip."""
    root = str(tmp_path_factory.mktemp("vmd"))
    make(root, frames=3, hw=(40, 52), seed=4)
    rng = np.random.RandomState(6)
    names = [f"clip_b/{i:05d}.png" for i in range(3)]
    alphas = rng.rand(3, 40, 52, 1)
    alphas[:, :10] = 0.0
    tris = rng.choice([0.0, 0.5, 1.0], (3, 40, 52, 1))
    return root, names, alphas, tris


def test_calc_metric_vis_is_the_jax_tools(pred_tree, tmp_path, monkeypatch):
    """calc_metric --vis, the port's and the JAX tool's run in this process
    on one tree: the same captioned PNG for each frame, byte for byte, and
    metric.json as without --vis."""
    from tcvom_tpu_torch.infer.predict import write_pred_pngs

    root, names, alphas, tris = pred_tree
    preds = {k: str(tmp_path / k) for k in ("jax", "port", "plain")}
    for pred in preds.values():
        write_pred_pngs(pred, names, alphas, tris, crop_hw=(40, 52))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import calc_metric as jax_tool
    monkeypatch.setattr(sys, "argv", ["calc_metric", "--pred", preds["jax"],
                                      "--data", root, "--vis",
                                      "--n_threads", "2"])
    jax_tool.main()
    got = calc_metric.main(["--pred", preds["port"], "--data", root, "--vis",
                            "--n_threads", "2"] + CPU)
    assert calc_metric.main(["--pred", preds["plain"], "--data", root,
                             "--n_threads", "2"] + CPU) == got
    assert not os.path.exists(os.path.join(preds["plain"], "vis"))
    for name in names:
        with open(os.path.join(preds["jax"], "vis", name), "rb") as f:
            want = f.read()
        with open(os.path.join(preds["port"], "vis", name), "rb") as f:
            assert f.read() == want, name
        assert cv2.imread(os.path.join(preds["port"], "vis", name)).shape \
            == (140, 104, 3)


def test_vis_without_cv2_names_it(pred_tree, tmp_path, monkeypatch):
    """Without OpenCV, --vis fails with an ImportError that names cv2
    before the sweep writes anything (or reads its checkpoint)."""
    monkeypatch.setattr(TAug, "cv2", None)
    monkeypatch.setattr(IO, "cv2", None)
    root, names, alphas, tris = pred_tree
    save = tmp_path / "pred"
    with pytest.raises(ImportError, match=r"--vis needs OpenCV \(cv2\)"):
        pred_single.main(["--model", "fba", "--data", root, "--load",
                          str(tmp_path / "none.pth"), "--trimap", "medium",
                          "--save",
                          str(save), "--image_shape", "40", "52",
                          "--n_threads", "0", "--vis"] + CPU)
    assert not save.exists()
    from tcvom_tpu_torch.infer.predict import write_pred_pngs
    write_pred_pngs(str(save), names, alphas, tris, crop_hw=(40, 52))
    with pytest.raises(ImportError, match=r"--vis needs OpenCV \(cv2\)"):
        calc_metric.main(["--pred", str(save), "--data", root, "--vis"]
                         + CPU)
    assert sorted(os.listdir(save)) == ["clip_b"]
