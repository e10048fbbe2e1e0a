"""The port's training data against the JAX package's, on the CPU: the
augmentations, the epoch order, VideoMatting108 training items (with and
without flow) and resize-path validation items, the Adobe-DIM pretrain
items, all for the same ``(seed, epoch, idx)`` on trees both packages'
makers write, and an item read by a loader's worker process after the
sampler's ``set_epoch``."""
import filecmp
import os
import shutil
import sys

import numpy as np
import pytest

from tcvom_tpu.data import augment as JAug
from tcvom_tpu.data import dim as JDim
from tcvom_tpu.data import loader as JLoader
from tcvom_tpu.data import vmd as JV
from tcvom_tpu_torch.data import augment as TAug
from tcvom_tpu_torch.data import dim as TDim
from tcvom_tpu_torch.data import loader as TLoader
from tcvom_tpu_torch.data import vmd as TV
from tcvom_tpu_torch.tools.make_fake_dataset import make, make_adobe
from tcvom_tpu_torch.utils import imageio as IO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (48, 48)


def _jax_makers():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_fake_dataset
    return make_fake_dataset


@pytest.fixture(scope="module")
def vmd_root(tmp_path_factory):
    """A VideoMatting108 tree of the port's maker: 2 clips x 5 frames of
    72x96."""
    root = str(tmp_path_factory.mktemp("vmd"))
    make(root, frames=5, hw=(72, 96), seed=4)
    return root


@pytest.fixture(scope="module")
def adobe_root(tmp_path_factory):
    """The Adobe-DIM tree of both makers: 3 stills, the same bytes."""
    roots = {}
    for name, maker in (("jax", _jax_makers().make_adobe),
                        ("port", make_adobe)):
        roots[name] = str(tmp_path_factory.mktemp(f"adobe_{name}"))
        maker(roots[name], n=3, hw=(60, 44), seed=5)
    return roots


def _assert_items_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- augmentations ---------------------------------------------------------

def test_pixel_and_jpeg_augmentations_match_jax(rng):
    """The draws from one RandomState, and each augmentation applied."""
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    for seed in range(6):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        jp, tp = JAug.PixelAug(jr).sample(), TAug.PixelAug(tr).sample()
        jq, tq = JAug.JpegAug(jr).sample(), TAug.JpegAug(tr).sample()
        assert tp == jp and tq == jq
        np.testing.assert_array_equal(TAug.PixelAug.apply(img, tp),
                                      JAug.PixelAug.apply(img, jp))
        np.testing.assert_array_equal(TAug.JpegAug.apply(img, tq),
                                      JAug.JpegAug.apply(img, jq))
    assert TAug.truncated_normal(np.random.RandomState(1), 0, 100, -1, 1) == \
        JAug.truncated_normal(np.random.RandomState(1), 0, 100, -1, 1)


@pytest.mark.parametrize("out_hw,floor", [((17, 29), True), ((40, 9), False),
                                          ((24, 32), True), ((1, 5), True)])
def test_resize_bilinear_ac_matches_jax(rng, out_hw, floor):
    img = (rng.rand(24, 32, 2) * 255).astype(np.float32)
    np.testing.assert_array_equal(
        TAug.resize_bilinear_ac(img, out_hw, floor),
        JAug.resize_bilinear_ac(img, out_hw, floor))


def test_augmentations_name_themselves_without_cv2(monkeypatch, rng):
    monkeypatch.setattr(TAug, "cv2", None)
    img = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    p = TAug.PixelAug(rng).sample()
    with pytest.raises(ImportError, match="PixelAug"):
        TAug.PixelAug.apply(img, p)
    with pytest.raises(ImportError, match="JpegAug"):
        TAug.JpegAug.apply(img, 80)
    assert TAug.JpegAug.apply(img, None) is img


# -- epoch order -----------------------------------------------------------

@pytest.mark.parametrize("n,shuffle,drop_last,block", [
    (10, True, True, 4), (10, False, True, 4), (7, True, False, 3),
    (12, True, True, 4), (1, True, True, 3)])
def test_epoch_indices_match_jax(n, shuffle, drop_last, block):
    for epoch in range(3):
        np.testing.assert_array_equal(
            TLoader.epoch_indices(n, epoch, shuffle, 777, drop_last, block),
            JLoader.epoch_indices(n, epoch, shuffle, 777, 1, 0, drop_last,
                                  block))


def test_sampler_walks_the_jax_loaders_order():
    """The sampler's keys over an epoch and the loader's length, against
    the JAX DataLoader's (wrapped to whole batches)."""
    sampler = TLoader.EpochSampler(10, 4, shuffle=True, seed=3)
    sampler.set_epoch(2)
    want = JLoader.epoch_indices(10, 2, True, 3, block=4)
    assert list(sampler) == [(2, int(i)) for i in want]
    assert len(sampler) == 12
    assert len(JLoader.DataLoader(list(range(10)), 4, seed=3)) == 3


# -- VideoMatting108 ---------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 3])
def test_train_items_match_jax(vmd_root, epoch):
    """Training items (the reversal draw, the scale crop, pixel and JPEG
    augmentation): every sample of the training clip at ``epoch``."""
    kw = dict(data_root=vmd_root, image_shape=SHAPE, mode="train",
              no_flow=True, sample_length=5, seed=777)
    want, got = JV.VideoMattingDataset(**kw), TV.VideoMattingDataset(**kw)
    want.set_epoch(epoch)
    assert got.samples == want.samples and len(got) == 5
    for i in range(len(got)):
        _assert_items_equal(got[(epoch, i)], want[i])


def test_val_resize_items_match_jax(vmd_root):
    """The validation resize path (no precomputed tree), S = 3, to a
    non-square shape."""
    kw = dict(data_root=vmd_root, image_shape=(40, 64), mode="val",
              no_flow=True, sample_length=3)
    want, got = JV.VideoMattingDataset(**kw), TV.VideoMattingDataset(**kw)
    for i in range(len(got)):
        _assert_items_equal(got[(0, i)], want[i])


def _random_flows(root: str, seed: int) -> None:
    """Overwrite every flow PNG of ``root`` with random int16 flow: a
    smooth field up to ~30 px (off the frame near its edges) with noise,
    +-60 px jumps, perpendicular patches and a quarter of the pixels
    invalid."""
    rng = np.random.RandomState(seed)
    for dirpath, _, files in sorted(os.walk(os.path.join(root, "flow_png"))):
        for fn in sorted(files):
            path = os.path.join(dirpath, fn)
            h, w = IO.imread(path, IO.IMREAD_UNCHANGED).shape[:2]
            yy, xx = np.mgrid[:h, :w]
            flow = np.stack([(xx - w / 2) * 0.6, (yy - h / 2) * 0.5], -1)
            flow = flow * rng.uniform(0.5, 1.5) + rng.normal(0, 0.4, (h, w, 2))
            jumps = rng.rand(h, w) < 0.03
            flow[jumps] += rng.choice([-60.0, 60.0], (jumps.sum(), 2))
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
            flow[y:y + 6, x:x + 6] = flow[y:y + 6, x:x + 6, ::-1] * (-1, 1)
            out = np.empty((h, w, 3), np.uint16)
            out[..., :2] = np.round(flow * 100).astype(np.int16).view(
                np.uint16)
            out[..., 2] = np.where(rng.rand(h, w) < 0.25, 0, 255)
            IO.imwrite(path, out)


def test_flow_waits_for_the_roadmap_off_the_pad_path(vmd_root, tmp_path):
    """Training items with flow (``no_flow=False``: the crop of each flow
    with its frames, flow_crop_and_resize) equal to the JAX package's, at
    epochs 0 and 3, on a tree with random flow PNGs: every flow the
    5-frame sample has, and NaN where it has none."""
    root = str(tmp_path / "vmd")
    shutil.copytree(vmd_root, root)
    _random_flows(root, seed=6)
    kw = dict(data_root=root, image_shape=SHAPE, mode="train",
              no_flow=False, sample_length=5, seed=777)
    want, got = JV.VideoMattingDataset(**kw), TV.VideoMattingDataset(**kw)
    for epoch in (0, 3):
        want.set_epoch(epoch)
        for i in range(len(got)):
            item = got[(epoch, i)]
            assert item["wb"].shape == (5,) + SHAPE + (2,)
            _assert_items_equal(item, want[i])
            finite = np.isfinite(item["wf"][1, ..., 0])
            assert 0.05 < finite.mean() < 0.95
            assert np.isnan(item["wf"][4]).all()


def test_worker_items_follow_the_sampler_epoch(vmd_root):
    """A loader of 2 spawned, persistent workers: after an epoch at 0 and
    ``set_epoch(1)`` on the sampler, each batch holds the items read here
    at epoch 1: the epoch reaches the workers in the keys."""
    ds = TV.VideoMattingDataset(vmd_root, SHAPE, "train", no_flow=True,
                                sample_length=3, seed=2)
    loader = TLoader.make_loader(ds, 2, num_workers=2, shuffle=True, seed=2,
                                 drop_last=True)
    first = next(iter(loader))
    loader.sampler.set_epoch(1)
    batches = list(loader)
    order = TLoader.epoch_indices(len(ds), 1, True, 2, block=2)
    assert len(batches) == len(loader) == 3
    for b, batch in enumerate(batches):
        for j, idx in enumerate(order[2 * b:2 * b + 2]):
            assert batch["idx"][j] == idx
            _assert_items_equal({k: v[j] for k, v in batch.items()},
                                ds[(1, int(idx))])
    assert not np.array_equal(first["fg"][0], ds[(1, int(first["idx"][0]))]
                              ["fg"])


# -- Adobe-DIM pretrain ----------------------------------------------------

def test_make_adobe_writes_the_jax_tree(adobe_root):
    jax_root, port_root = adobe_root["jax"], adobe_root["port"]
    names = sorted(os.path.relpath(os.path.join(d, f), jax_root)
                   for d, _, fs in os.walk(jax_root) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), port_root)
                           for d, _, fs in os.walk(port_root) for f in fs)
    _, mismatch, errors = filecmp.cmpfiles(jax_root, port_root, names,
                                           shallow=False)
    assert (mismatch, errors) == ([], [])


@pytest.mark.parametrize("epoch", [0, 2])
def test_dim_pretrain_items_match_jax(adobe_root, epoch):
    """The synthesized 3-frame items (resize to the minimum shape, crops,
    the affine chains re-rolled until unknown pixels remain, flip, crop
    and resize) for every still at ``epoch``."""
    kw = dict(data_root=adobe_root["jax"], image_shape=(64, 64),
              min_shape=96, plus1=False, seed=9)
    want, got = JDim.DIMPretrainDataset(**kw), TDim.DIMPretrainDataset(**kw)
    assert got.sample_fn == want.sample_fn and len(got) == 3
    want.set_epoch(epoch)
    for i in range(len(got)):
        item = got[(epoch, i)]
        assert item["a"].shape == (3, 64, 64, 1)
        _assert_items_equal(item, want[i])


def test_synth_frames3_matches_jax(rng):
    fg = rng.randint(0, 256, (50, 40, 3)).astype(np.uint8)
    bg = rng.randint(0, 256, (60, 70, 3)).astype(np.uint8)
    a = np.zeros((50, 40), np.uint8)
    a[10:40, 8:30] = 255
    a[14:36, 12:26] = 128
    want = JDim.synth_frames3(fg, bg, a, np.random.RandomState(3))
    got = TDim.synth_frames3(fg, bg, a, np.random.RandomState(3))
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        for gi, wi in zip(g, w):
            np.testing.assert_array_equal(gi, wi)
