"""``pred_vmn --space`` under ``python -m torch.distributed.run
--standalone`` on the CPU (gloo, ``--device cpu``) against the one-process
tool, on a fake VideoMatting108 tree (one validation clip of 3 samples,
64x96, B = 1, window 3, medium trimaps):

- ``--model fba`` (``layers`` (1, 1, 1, 1), random weights) on 2 ranks
  (one space group) and on 4 (2 data groups x 2 space ranks, the samples
  dealt 2 and 1);
- ``--model dim`` (published widths, calibrated weights) on 2 ranks, its
  model and batches in f64 on both sides (the ranks run this file as
  their script, :func:`in_f64`): in f32 a change of the convolutions'
  rounding alone flips near-ties of DIM's 2x2 argmax pools (on this clip
  one at pool 5 moves the one-process f32 sweep's alphas by 0.017 from
  its f64 sweep, and the banded f32 sweep's by 1.6e-5), which the
  one-level bound does not admit. ``test_torch_space.py`` holds DIM's
  banded f32 step against JAX's;
- ``--model index`` (published widths, calibrated weights) on 2 ranks, in
  f32;
- ``--model gca`` (published widths, spectral norms converged, calibrated
  weights) on 2 ranks, in f64 as DIM (its attention amplifies f32
  rounding, ``test_torch_gca_model.py``).

Each run writes the one-process file list, PNGs within one level and at
least 99.9 % identical, and loss.log within rtol 1e-5."""
import contextlib
import os
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import (build_model,
                                             calibrate_random_weights,
                                             converge_spectral_norms)
from tcvom_tpu_torch.infer import predict
from tcvom_tpu_torch.tools import make_fake_dataset, pred_vmn
from tcvom_tpu_torch.utils.checkpoint import save_weights
from tcvom_tpu_torch.utils.imageio import IMREAD_GRAYSCALE, imread
from test_torch_dist import torchrun, wait_all

HW = (64, 96)
# (model, ranks): one space group, and two data groups of two
RUNS = (("fba", 2), ("fba", 4), ("dim", 2), ("index", 2), ("gca", 2))
# the models whose runs are in f64 (in_f64): the rest in f32
F64 = ("dim", "gca")


def _args(files, model: str, save, *extra):
    return [str(a) for a in (
        "--model", model, "--data", files / "vmd", "--load",
        files / f"vmn_{model}.pth", "--trimap", "medium", "--save", save,
        "--image_shape", *HW, "--n_threads", "0", "--batch", "1",
        "--agg_window", "3", "--device", "cpu", *extra)]


@contextlib.contextmanager
def in_f64():
    """``pred_vmn`` with its model and batches in f64."""
    load = pred_vmn.load_model

    def upload(model, batch):
        return {k: torch.as_tensor(batch[k]).double() for k in ("a", "fg",
                                                                "bg")}

    with mock.patch.object(predict, "_upload_batch", upload), \
            mock.patch.object(pred_vmn, "load_model",
                              lambda *a, **kw: load(*a, **kw).double()):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The fake tree and the models' .pth (all but FBA's calibrated on a
    clip of the tree's size: random DIM weights give mattes of ~1e-5;
    GCA's spectral norms converged first)."""
    tmp = tmp_path_factory.mktemp("space_tools")
    make_fake_dataset.make(str(tmp / "vmd"), frames=3, hw=HW, seed=9)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in ("vmn_fba", "vmn_dim", "vmn_index", "vmn_gca"):
            model = build_model(name, agg_window=3, layers=(1, 1, 1, 1),
                                device="cpu")
            if name == "vmn_gca":
                converge_spectral_norms(model)
            if name != "vmn_fba":
                rng = np.random.RandomState(3)
                a = np.zeros((1, 3) + HW + (1,), np.float32)
                a[:, :, 16:48, 24:72] = 255
                a[:, :, 20:44, 30:66] = rng.uniform(0, 255, (1, 3, 24, 36, 1))
                batch = {"a": torch.from_numpy(a), **{
                    k: torch.from_numpy(rng.randint(
                        0, 256, (1, 3) + HW + (3,)).astype(np.float32))
                    for k in ("fg", "bg")}}
                cfg = TFM.TaskConfig(model=name, agg_window=3,
                                     dilate_radius=12)
                calibrate_random_weights(model, lambda: TFM.forward_vmd(
                    model, batch, cfg))
            save_weights(model, str(tmp / f"{name}.pth"))
    finally:
        torch.set_num_threads(threads)
    return tmp


@pytest.fixture(scope="module")
def sweeps(files):
    """{(model, ranks): (the one-process folder, the ranks' folder)}: the
    three launches run while this process sweeps each model once."""
    procs = [torchrun(
        os.path.abspath(__file__) if model in F64
        else "tcvom_tpu_torch.tools.pred_vmn",
        _args(files, model, files / f"{model}{n}", "--space", 2), n=n)
        for model, n in RUNS]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for model in sorted({m for m, _ in RUNS}):
            with in_f64() if model in F64 else contextlib.nullcontext():
                pred_vmn.main(_args(files, model, files / f"{model}1"))
    finally:
        torch.set_num_threads(threads)
    wait_all(procs, 600)
    return {(m, n): (files / f"{m}1", files / f"{m}{n}") for m, n in RUNS}


def _losses(folder) -> dict:
    return {k: float(v) for k, v in (
        line.split(": ") for line in
        (folder / "loss.log").read_text().splitlines() if line)}


@pytest.mark.parametrize("model,n", RUNS)
def test_space_sweep_writes_the_one_process_files(sweeps, model, n):
    one, banded = sweeps[(model, n)]
    names = sorted(os.listdir(one / "clip_b"))
    assert names == sorted(os.listdir(banded / "clip_b"))
    assert names == [f"{i:05d}_{k}.png" for i in range(3)
                     for k in ("pred", "tri")]
    live = 0
    for name in names:
        want, got = (imread(str(d / "clip_b" / name), IMREAD_GRAYSCALE)
                     .astype(int) for d in (one, banded))
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, name
        live += int(((want > 0) & (want < 255)).sum())
    assert live > 100
    want, got = _losses(one), _losses(banded)
    assert sorted(got) == sorted(want) and want["L_total"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_space_needs_whole_space_groups(files):
    """One process is no group of two ranks."""
    with pytest.raises(ValueError, match="space groups of 2"):
        pred_vmn.main(_args(files, "fba", files / "refused", "--space", 2))


if __name__ == "__main__":
    with in_f64():
        pred_vmn.main(sys.argv[1:])
