"""The port's command-line tools on the CPU (``--device cpu``), FBA at a small
depth (the tools build the depth an FBA checkpoint holds): pred_test over a
root of videos with --shard (and GCA's VMN on one folder), pred_vmn (FBA,
IndexNet, GCA) then calc_metric on a fake VideoMatting108 tree with the
zlib PNG codec standing in for OpenCV, pred_single (FBA, DIM with --vis,
GCA) and its Adobe-DIM sweep (FBA with --vis, DIM), and the flags that are
not ported yet."""
import argparse
import json
import os

import numpy as np
import pytest
import torch

from tcvom_tpu_torch.models.registry import (build_model,
                                             converge_spectral_norms)
from tcvom_tpu_torch.tools import (calc_metric, common, make_fake_dataset,
                                   pred_single, pred_test, pred_vmn)
from tcvom_tpu_torch.tools.common import PUBLISHED_LAYERS, encoder_depth
from tcvom_tpu_torch.utils import imageio as IO
from tcvom_tpu_torch.utils.checkpoint import save_weights

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name in ("vmn_fba", "fba", "dim", "vmn_index", "vmn_gca", "gca"):
        out[name] = str(tmp / f"{name}.pth")
        model = build_model(name, agg_window=3, layers=(1, 1, 1, 1),
                            device="cpu")
        # GCA's random u and v give sigma near 0 and of either sign
        converge_spectral_norms(model)
        save_weights(model, out[name])
    return out


@pytest.fixture
def zlib_codec(monkeypatch):
    """Image files through the port's own PNG codec, as on a machine
    without OpenCV."""
    monkeypatch.setattr(IO, "cv2", None)


def test_pred_test_shards_videos(ckpts, tmp_path):
    root = tmp_path / "wild"
    for i, v in enumerate(("clipA", "clipB", "clipC")):
        make_fake_dataset.make_wild_folder(str(root / v), frames=2,
                                           hw=(40, 70), seed=i)
    base = ["--model", "fba", "--vmn", "--load", ckpts["vmn_fba"], "--data",
            str(root), "--agg_window", "3"] + CPU
    # shard i of N takes videos [i*3//N, (i+1)*3//N): 0/2 is clipA alone
    stats = pred_test.main(base + ["--save", str(tmp_path / "s0"),
                                   "--shard", "0/2", "--dilation", "2"])
    assert os.listdir(tmp_path / "s0") == ["clipA"]
    assert [s["frames"] for s in stats] == [2]
    pred_test.main(base + ["--save", str(tmp_path / "s1"), "--shard", "1/2"])
    assert sorted(os.listdir(tmp_path / "s1")) == ["clipB", "clipC"]
    for i in range(2):
        a = IO.imread(str(tmp_path / "s1" / "clipC" / f"{i:05d}_alpha.png"),
                      IO.IMREAD_GRAYSCALE)
        assert a.shape == (40, 70)
    # a positional selection, single-frame model
    pred_test.main(["--model", "fba", "--load", ckpts["fba"], "--data",
                    str(root), "--save", str(tmp_path / "one"), "clipB"]
                   + CPU)
    assert os.listdir(tmp_path / "one") == ["clipB"]
    with pytest.raises(SystemExit):
        pred_test.main(base + ["--save", str(tmp_path / "x"),
                               "--shard", "2/2"])


@pytest.mark.parametrize("vmn", [True, False])
def test_pred_test_gca(ckpts, tmp_path, vmn):
    """GCA's VMN (the stream) and its single-frame model on one folder."""
    src, save = str(tmp_path / "wild"), tmp_path / "out"
    make_fake_dataset.make_wild_folder(src, frames=3, hw=(40, 70))
    stats = pred_test.main(
        ["--model", "gca", "--load", ckpts["vmn_gca" if vmn else "gca"],
         "--data", src, "--save", str(save), "--agg_window", "3"]
        + (["--vmn"] if vmn else []) + CPU)
    assert [s["frames"] for s in stats] == [3]
    for i in range(3):
        a = IO.imread(str(save / f"{i:05d}_alpha.png"), IO.IMREAD_GRAYSCALE)
        assert a.shape == (40, 70) and a.dtype == np.uint8


@pytest.mark.parametrize("model", ["fba", "index", "gca"])
def test_pred_vmn_then_calc_metric(ckpts, tmp_path, zlib_codec, model):
    data, save = str(tmp_path / "vmd"), str(tmp_path / "pred")
    make_fake_dataset.make(data, frames=3, hw=(64, 96))
    losses = pred_vmn.main(["--model", model, "--data", data, "--load",
                            ckpts["vmn_" + model], "--trimap", "medium",
                            "--save",
                            save, "--agg_window", "3", "--batch", "2",
                            "--image_shape", "64", "96", "--n_threads", "0"]
                           + CPU)
    assert set(losses) == {"L_alpha", "L_comp", "L_grad", "L_dt", "L_att",
                           "L_total"}
    assert all(np.isfinite(v) for v in losses.values())
    assert os.path.exists(os.path.join(save, "loss.log"))
    for i in range(3):
        for sfx in ("pred", "tri"):
            x = IO.imread(os.path.join(save, "clip_b", f"{i:05d}_{sfx}.png"),
                          IO.IMREAD_UNCHANGED)
            assert x.shape == (64, 96) and x.dtype == np.uint8
    agg = calc_metric.main(["--pred", save, "--data", data, "--device",
                            "cpu", "--n_threads", "2"])
    with open(os.path.join(save, "metric.json")) as f:
        assert json.load(f) == agg
    assert list(agg["all"]) == ["clip_b"]
    for k in calc_metric.METRIC_KEYS:
        assert np.isfinite(agg["avg"][k]), k


@pytest.mark.parametrize("model", ["fba", "dim", "gca"])
def test_pred_single(ckpts, tmp_path, model):
    data, save = str(tmp_path / "vmd"), str(tmp_path / "pred")
    make_fake_dataset.make(data, frames=2, hw=(64, 64))
    vis = ["--vis"] if model == "dim" else []
    res = pred_single.main(["--model", model, "--data", data, "--load",
                            ckpts[model], "--trimap", "narrow", "--save",
                            save, "--image_shape", "64", "64",
                            "--n_threads", "0", "--batch", "2"] + vis + CPU)
    assert set(res) == {"mSAD", "MSE"} and 0 < res["mSAD"] < 1
    assert sorted(os.listdir(os.path.join(save, "clip_b"))) == [
        "00000_pred.png", "00000_tri.png", "00001_pred.png", "00001_tri.png"]
    if vis:          # pred | gt and the caption strip, a sample
        for i in range(2):
            x = IO.imread(os.path.join(save, "vis", "clip_b", f"{i:05d}.png"))
            assert x.shape == (64 + 100, 2 * 64, 3)


@pytest.fixture
def one_thread():
    """The port's CPU work on one intra-op thread: beside the test run's
    other workers, many threads a process stall each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model", ["fba", "dim"])
def test_pred_single_adobe(ckpts, tmp_path, one_thread, model):
    """The Adobe-DIM still-image sweep at the resize grid of 64: the PNGs
    at the JAX tool's crops (the still's size cut to the grid), finite
    mSAD and MSE, and with --vis (FBA) one captioned image a still."""
    data, save = str(tmp_path / "adobe"), tmp_path / "pred"
    make_fake_dataset.make_adobe(data, n=2, hw=(80, 56))
    vis = ["--vis"] if model == "fba" else []
    res = pred_single.main(["--model", model, "--data", data, "--load",
                            ckpts[model], "--trimap", "medium", "--save",
                            str(save), "--dataset", "adobe", "--val_mode",
                            "resize", "--min_shape", "64", "--batch", "2",
                            "--n_threads", "0"] + vis + CPU)
    assert set(res) == {"mSAD", "MSE"}
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    for i, crop in enumerate([(64, 56), (64, 60)]):
        for sfx in ("pred", "tri"):
            x = IO.imread(str(save / f"{i:05d}_{sfx}.png"),
                          IO.IMREAD_UNCHANGED)
            assert x.shape == crop and x.dtype == np.uint8
        if vis:
            x = IO.imread(str(save / "vis" / f"{i:05d}.png"))
            assert x.shape == (crop[0] + 100, 2 * crop[1], 3)
    assert os.path.exists(save / "loss.log")
    assert os.path.isdir(save / "vis") == bool(vis)


def test_tools_raise_for_what_is_not_ported(ckpts, tmp_path):
    base = ["--data", str(tmp_path), "--load", ckpts["fba"], "--trimap",
            "medium"] + CPU
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pred_vmn.main(["--model", "fba", "--space", "2"] + base)
    # a directory (the JAX package's orbax checkpoint) is not read
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pred_test.main(["--model", "gca", "--vmn", "--load", str(tmp_path),
                        "--data", str(tmp_path), "--save", str(tmp_path),
                        "v"] + CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pred_test.main(["--model", "fba", "--load", ckpts["fba"],
                            "--data", str(tmp_path), "--save",
                            str(tmp_path), "v"])


def test_tools_build_the_checkpoints_depth():
    for layers in ((1, 1, 1, 1), (2, 1, 3, 1)):
        sd = build_model("vmn_fba", layers=layers, device="cpu").state_dict()
        assert encoder_depth(sd) == layers
    assert encoder_depth({"decoder.conv_up4.0.weight": None}) == \
        PUBLISHED_LAYERS


def test_tools_take_no_depth_from_other_backbones(ckpts, monkeypatch):
    """IndexNet's keys have the form of a ResNet's stages
    (``encoder.layer1.0.conv.0``); only FBA's build reads a depth there."""
    sd = torch.load(ckpts["vmn_index"])
    assert encoder_depth(sd) != PUBLISHED_LAYERS
    built = []

    def spy(name, **kw):
        built.append(kw["layers"])
        return build_model(name, **kw)

    monkeypatch.setattr(common, "build_model", spy)
    args = argparse.Namespace(load=ckpts["vmn_index"], device="cpu")
    common.load_model("vmn_index", args, agg_window=3)
    common.load_model("vmn_fba", argparse.Namespace(
        load=ckpts["vmn_fba"], device="cpu"), agg_window=3)
    assert built == [PUBLISHED_LAYERS, (1, 1, 1, 1)]


@pytest.mark.parametrize("tool", [pred_test, pred_vmn, pred_single,
                                  calc_metric])
def test_tools_print_their_help(tool, capsys):
    with pytest.raises(SystemExit) as e:
        tool.main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out
