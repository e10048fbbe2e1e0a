"""The port's tools under ``python -m torch.distributed.run --standalone``
on the CPU (two ranks over gloo, ``--device cpu``) against one process:

- ``tools.train`` on a fake VideoMatting108 tree, ``vmn_gca`` at 64x64,
  S = 3, window 3, random radii, validating every epoch: an epoch in one
  process at B = 4; then, at the same time, an epoch on two ranks at
  B = 2 from the same weights, and the second epoch resumed from the
  one-process run's checkpoint on two ranks and in one process (the
  port's counterpart of the JAX package's tests/test_multihost.py:79):
  the logged losses and validation L_dt, the files only rank 0 writes,
  ``checkpoint_<n>.pth`` and ``best.pth`` with the one-process run's keys
  (GCA's spectral-norm ``module.weight_bar`` among them, through the JAX
  package's converter alike) and weights;
- ``pred_vmn`` and ``pred_single`` (FBA, three samples at a batch of 1:
  two on rank 0, one on rank 1): the PNGs byte for byte and the reported
  metrics."""
import json
import os
import re
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from tcvom_tpu_torch.models.registry import (build_model,
                                             converge_spectral_norms)
from tcvom_tpu_torch.tools import make_fake_dataset, pred_single, pred_vmn
from tcvom_tpu_torch.tools import train
from tcvom_tpu_torch.utils.checkpoint import save_weights
from test_torch_dist import ROOT, torchrun, wait_all

CFG = os.path.join(ROOT, "cfgs", "vmd_vmn_gca_pretrained_30ep.yaml")
OUT = "vmd_vmn_gca_pretrained_30ep_agg7"
STATS = ("running_mean", "running_var", "weight_u", "weight_v")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A fake tree (training: clip_a, 4 frames; validation: clip_b), a
    ``vmn_gca`` .pth (u, v converged) and FBA's at depth (1, 1, 1, 1)."""
    tmp = tmp_path_factory.mktemp("dist_tools")
    make_fake_dataset.make(str(tmp / "vmd"), frames=4, hw=(72, 96), seed=7)
    make_fake_dataset.make(str(tmp / "pred"), frames=3, hw=(64, 96), seed=8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in ("vmn_gca", "vmn_fba", "fba"):
            model = build_model(name, agg_window=3, layers=(1, 1, 1, 1),
                                device="cpu")
            if name == "vmn_gca":
                converge_spectral_norms(model)
            save_weights(model, str(tmp / f"{name}.pth"))
    finally:
        torch.set_num_threads(threads)
    return tmp


def _train_args(files, out, batch: int, *opts):
    return ["--cfg", CFG, "--device", "cpu", "--sample_length", "3",
            "SYSTEM.OUTDIR", out,
            "SYSTEM.NUM_WORKERS", "0", "AGG_WINDOW", "3", "DATASET.PATH",
            files / "vmd", "TRAIN.LOAD_CKPT", files / "vmn_gca.pth",
            "TRAIN.BATCH_SIZE_PER_GPU", batch, "TRAIN.TRAIN_INPUT_SIZE",
            "[64, 64]", "TRAIN.VAL_INPUT_SIZE", "[64, 96]",
            "TRAIN.PRINT_FREQ", 1, "TRAIN.IMAGE_FREQ", 1, *opts]


def _log(folder, suffix: str = "_train.log") -> str:
    (log,) = [f for f in os.listdir(folder) if f.endswith(suffix)]
    with open(os.path.join(folder, log)) as f:
        return f.read()


def _losses(folder) -> list[float]:
    """The ``Current: Loss`` of each step, from the rank-0 log."""
    return [float(v) for v in re.findall(r"Current: Loss: ([0-9.]+)",
                                          _log(folder))]


def _val(folder, suffix: str = "_train.log") -> list[str]:
    """Each epoch's logged validation L_dt, as written."""
    return re.findall(r"epoch \d+ val L_dt: ([0-9.]+)", _log(folder, suffix))


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """(one process: the first epoch; two ranks: the first epoch; two
    ranks resumed and one process resumed: the second epoch from the
    one-process run's ``checkpoint_1.pth``): their output folders, and
    their checkpoints and ``best.pth`` ({folder: {name: (step or None,
    model state_dict)}}, each read once and emptied: GCA's train states
    are ~300 MB each); the last three run at the same time. Every run
    validates from its first epoch (``VAL_FROM_EPOCH`` 0: in this process,
    and in the ranks, which run this file as their script)."""
    tmp = tmp_path_factory.mktemp("dist_train")
    outs = tuple(tmp / d / OUT for d in ("one", "two", "resumed",
                                         "one_resumed"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.object(train, "VAL_FROM_EPOCH", 0):
            train.main([str(a) for a in _train_args(
                files, tmp / "one", 4, "TRAIN.TOTAL_STEPS", 1)])
            resume = ("TRAIN.TOTAL_STEPS", 2, "TRAIN.LOAD_OPT",
                      outs[0] / "checkpoint_1.pth")
            procs = [torchrun(os.path.abspath(__file__), _train_args(
                files, tmp / name, 2, *opts)) for name, opts in (
                    ("two", ("TRAIN.TOTAL_STEPS", 1)), ("resumed", resume))]
            train.main([str(a) for a in _train_args(
                files, tmp / "one_resumed", 4, *resume)])
    finally:
        torch.set_num_threads(threads)
    wait_all(procs, 600)
    ckpts = {}
    for out in outs:
        for path in sorted(out.glob("*.pth")):
            state = torch.load(path)
            ckpts.setdefault(out, {})[path.name] = (
                (state["step"], state["model"]) if "model" in state
                else (None, state))
            del state
            path.write_bytes(b"")
    return outs, ckpts


def test_two_ranks_log_the_one_process_losses(runs):
    """The losses the runs log (a step an epoch: 4 training samples, B = 2
    on each of two ranks or B = 4 in one process) within rtol 2e-4, the
    JAX package's own two-process tolerance."""
    (one, two, resumed, one_resumed), _ = runs
    want = _losses(one) + _losses(one_resumed)
    got = _losses(two) + _losses(resumed)
    assert len(want) == 2 and all(v > 0 for v in want)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_two_ranks_validate_as_one_process(runs):
    """Each epoch's validation L_dt (the 4 samples of the validation clip
    in one global batch: B = 2 on each rank) logged by both ranks alike
    and within rtol 2e-4 of the one-process run's; ``best.pth`` of two
    ranks holds the one-process run's keys and the weights of the epoch's
    own ``checkpoint_1.pth``, bit for bit."""
    (one, two, resumed, one_resumed), ckpts = runs
    for got, want in ((two, one), (resumed, one_resumed)):
        values = _val(got)
        assert len(values) == 1 and values == _val(got, "_train_p1.log")
        np.testing.assert_allclose(float(values[0]), float(_val(want)[0]),
                                   rtol=2e-4)
        assert float(values[0]) > 0
    best = ckpts[two]["best.pth"][1]
    assert sorted(best) == sorted(ckpts[one]["best.pth"][1])
    for k, v in ckpts[two]["checkpoint_1.pth"][1].items():
        assert torch.equal(best[k], v), k
    assert "best.pth" in ckpts[resumed]


def test_rank_zero_alone_writes(runs):
    """Rank 0 writes the config, the log, the image grids, the validation
    triplets, the checkpoint, best.pth and train_stats.json (with
    ``ranks`` 2); rank 1 logs to ``..._train_p1.log`` only."""
    (one, two, _, _), _ = runs
    names = sorted(os.listdir(two))
    logs = [n for n in names if n.endswith(".log")]
    assert len(logs) == 2 and sum(n.endswith("_train_p1.log")
                                  for n in logs) == 1
    assert [n for n in names if not n.endswith(".log")] == [
        "best.pth", "checkpoint_1.pth", "config.yaml", "train_stats.json",
        "training_images", "val_images"]
    assert sorted(os.listdir(two / "training_images")) == sorted(
        os.listdir(one / "training_images"))
    assert os.listdir(two / "val_images" / "epoch_0")
    with open(two / "train_stats.json") as f:
        stats = json.load(f)
    assert stats["ranks"] == 2 and stats["step"] == 1


def test_checkpoints_have_the_one_process_keys_and_weights(runs):
    """``checkpoint_1.pth`` of two ranks holds the one-process run's keys,
    GCA's ``module.weight_bar`` among them and no key with a DDP
    ``module.`` prefix; the JAX package's converter maps both alike. The
    two ranks' resumed ``checkpoint_2.pth`` carries on the step count and
    its weights are the one-process resume's, as far as f32 Adam shows
    it: Adam moves each weight by ~lr a step whatever its gradient's
    size, so a gradient within rounding of 0 (a bias before a
    training-mode BatchNorm, GCA's zero-initialised ``bn2`` scales) may
    move a weight the other way; fewer than 1 % of the weights are more
    than lr/10 apart (2 of 25.6 M measured), and the running statistics
    and the spectral-norm ``u``, ``v`` (which follow the weights) within
    1e-3 (1.3e-5 measured), the step counts and ``num_batches_tracked``
    equal."""
    from tcvom_tpu.utils.convert import convert_state_dict

    (one, two, resumed, one_resumed), ckpts = runs
    a = ckpts[one]["checkpoint_1.pth"][1]
    b = ckpts[two]["checkpoint_1.pth"][1]
    assert sorted(a) == sorted(b)
    assert any(k.endswith("module.weight_bar") for k in b)
    assert not any(k.startswith("module.") for k in b)
    ja, unmatched_a = convert_state_dict("vmn_gca", {k: v.numpy()
                                                     for k, v in a.items()})
    jb, unmatched_b = convert_state_dict("vmn_gca", {k: v.numpy()
                                                     for k, v in b.items()})
    assert unmatched_a == unmatched_b == []

    def keys(tree, path=()):
        if isinstance(tree, dict):
            return sorted(k for n, v in tree.items()
                          for k in keys(v, path + (n,)))
        return ["/".join(path)]

    assert keys(ja) == keys(jb)
    want_step, want = ckpts[one_resumed]["checkpoint_2.pth"]
    got_step, got = ckpts[resumed]["checkpoint_2.pth"]
    assert got_step == want_step == 2
    lr = 1e-4                       # the config's BASE_LR, poly
    moved = n = 0
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            assert torch.equal(g, w), k
        elif k.endswith(STATS):
            err = float((g - w).norm() / w.norm())
            assert err <= 1e-3, (k, err)
        else:
            moved += int(((g - w).abs() > lr / 10).sum())
            n += w.numel()
    assert moved <= 0.01 * n, (moved, n)


@pytest.fixture(scope="module")
def preds(files, tmp_path_factory):
    """pred_vmn and pred_single under two ranks and in one process:
    {tool: (one-process result, one folder, two folder)}."""
    tmp = tmp_path_factory.mktemp("dist_pred")

    def args(tool, save):
        model = "vmn_fba" if tool == "pred_vmn" else "fba"
        extra = ["--agg_window", "3"] if tool == "pred_vmn" else []
        return ["--model", "fba", "--data", files / "pred", "--load",
                files / f"{model}.pth", "--trimap", "medium", "--save",
                save, "--image_shape", "64", "96", "--n_threads", "0",
                "--batch", "1", "--device", "cpu", *extra]

    procs = [torchrun(f"tcvom_tpu_torch.tools.{t}", args(t, tmp / f"{t}2"))
             for t in ("pred_vmn", "pred_single")]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = {t: mod.main([str(a) for a in args(t, tmp / f"{t}1")])
               for t, mod in (("pred_vmn", pred_vmn),
                              ("pred_single", pred_single))}
    finally:
        torch.set_num_threads(threads)
    wait_all(procs, 600)
    return {t: (res[t], tmp / f"{t}1", tmp / f"{t}2") for t in res}


@pytest.mark.parametrize("tool", ["pred_vmn", "pred_single"])
def test_pred_ranks_write_the_one_process_files(preds, tool):
    """Every PNG byte for byte (three samples' pred and tri), and the
    loss.log metrics, summed over the ranks, within rtol 1e-9."""
    res, one, two = preds[tool]
    files = sorted(os.listdir(one / "clip_b"))
    assert files == [f"{i:05d}_{k}.png" for i in range(3)
                     for k in ("pred", "tri")]
    assert sorted(os.listdir(two / "clip_b")) == files
    for name in files:
        assert (one / "clip_b" / name).read_bytes() == \
            (two / "clip_b" / name).read_bytes(), name

    def read(folder):
        with open(folder / "loss.log") as f:
            return dict(line.split(": ") for line in f.read().split("\n")
                        if line)

    got, want = read(two), read(one)
    assert sorted(got) == sorted(want) == sorted(res)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


if __name__ == "__main__":
    # a rank of the runs' two-rank trainings, validating from epoch 0
    train.VAL_FROM_EPOCH = 0
    train.main(sys.argv[1:])
