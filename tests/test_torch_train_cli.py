"""The port's checkpoints and training CLI on the CPU: the encoder's
ImageNet initialisation against the JAX package's, train-state save and
restore, and ``python -m tcvom_tpu_torch.tools.train`` run in process on
fake trees: it writes its checkpoints, logs and images, and a run resumed
from an epoch's checkpoint ends bit for bit where an uninterrupted run
ends (step, weights, BatchNorm statistics, Adam moments, generators); the
TAM pretrain on the DIM data keeps its frozen backbone as loaded."""
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcvom_tpu.models import fba as JF
from tcvom_tpu.models.vmn import VMN as JVMN
from tcvom_tpu.utils.checkpoint import (
    load_imagenet_encoder as jax_load_imagenet_encoder)
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.tools import train
from tcvom_tpu_torch.tools.make_fake_dataset import make, make_adobe
from tcvom_tpu_torch.train.trainer import MattingTrainer
from tcvom_tpu_torch.utils.checkpoint import (load_imagenet_encoder,
                                              read_state_dict,
                                              restore_train_state,
                                              save_train_state, save_weights)
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict
from test_torch_train_bn import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (1, 1, 1, 1)


def test_imagenet_encoder_init_matches_jax(tmp_path, rng):
    """A torch ResNet state_dict the test writes (3-channel stem,
    BatchNorm statistics and a classifier the model lacks): the port's
    encoder after the load against the JAX package's variables after its
    own, through the converter; the stem widened with zero channels."""
    port = build_model("vmn_fba", agg_window=3, layers=LAYERS, device="cpu")
    own = port.state_dict()
    sd = {k.removeprefix("encoder."): torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32)) for k, v in own.items()
        if k.startswith("encoder.")}
    sd["conv1.weight"] = sd["conv1.weight"][:, :3].clone()
    sd.update({"bn1.running_mean": torch.zeros(64), "fc.weight":
               torch.ones(10, 2048), "fc.bias": torch.zeros(10)})
    path = str(tmp_path / "resnet.pth")
    torch.save(sd, path)

    missing, unexpected = load_imagenet_encoder(port, path)
    assert unexpected == ["encoder.bn1.running_mean", "encoder.fc.bias",
                          "encoder.fc.weight"]
    assert missing and not any(k.startswith("encoder.") for k in missing)
    module = JVMN(encoder=JF.FBAEncoder(layers=LAYERS),
                  decoder=JF.FBADecoderVMN(), fam_channels=256,
                  agg_window=3)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, 64, 64, 11)),
        jnp.ones((1, 3, 64, 64, 1)), extras=(jnp.zeros((1, 3, 64, 64, 3)),
                                             jnp.zeros((1, 3, 64, 64, 2))),
        train=False))
    init = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    merged, _, _ = jax_load_imagenet_encoder("vmn_fba", init, path)
    want = jax_to_torch_state_dict("vmn_fba", jax.tree.map(np.asarray,
                                                           merged))
    got = port.state_dict()
    enc = [k for k in want if k.startswith("encoder.")]
    assert len(enc) == len([k for k in sd if not k.startswith(("fc",
                                                               "bn1.r"))])
    for k in enc:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    stem = got["encoder.conv1.weight"]
    assert stem.shape[1] == 11 and not stem[:, 3:].any()


def test_train_state_round_trip(tmp_path):
    """A step, a save, another step; a fresh state restored from the save
    and stepped once ends where the first did (IndexNet: dropout live,
    BatchNorm statistics, Adam)."""
    trainer = MattingTrainer(TaskConfig(model="vmn_index", agg_window=3),
                             "vmd", device="cpu")
    rng = np.random.RandomState(0)
    batch = {"a": torch.from_numpy(np.clip(
        rng.rand(1, 3, 64, 64, 1) * 600 - 200, 0, 255).astype(np.float32)),
             **{k: torch.from_numpy((rng.rand(1, 3, 64, 64, 3) * 255)
                                    .astype(np.float32)) for k in ("fg",
                                                                   "bg")}}
    state = trainer.init_state(torch.Generator().manual_seed(3))
    trainer.train_step(state, batch)
    path = str(tmp_path / "state.pth")
    save_train_state(path, state)
    trainer.train_step(state, batch)
    resumed = restore_train_state(
        path, trainer.init_state(torch.Generator().manual_seed(4)))
    assert resumed.step == 1
    trainer.train_step(resumed, batch)
    assert resumed.step == state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert torch.equal(resumed.generator.get_state(),
                       state.generator.get_state())
    assert torch.equal(resumed.dropout_generator.get_state(),
                       state.dropout_generator.get_state())
    assert sorted(read_state_dict(path)) == sorted(
        state.model.state_dict())
    with pytest.raises(ValueError, match="LOAD_CKPT"):
        save_weights(state.model, str(tmp_path / "w.pth"))
        restore_train_state(str(tmp_path / "w.pth"), state)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A VideoMatting108 tree (2 clips x 4 frames of 72x96), an Adobe-DIM
    tree (2 stills) and a random vmn_index .pth."""
    root = tmp_path_factory.mktemp("trees")
    make(str(root / "vmd"), frames=4, hw=(72, 96), seed=7)
    make_adobe(str(root / "adobe"), n=2, hw=(80, 56), seed=8)
    save_weights(build_model("vmn_index", agg_window=3, device="cpu"),
                 str(root / "index.pth"))
    return root


def _argv(cfg, out, *opts, flags=()):
    return ["--cfg", os.path.join(ROOT, "cfgs", cfg), "--device", "cpu",
            *flags, "SYSTEM.OUTDIR", str(out), "SYSTEM.NUM_WORKERS", "0",
            "AGG_WINDOW", "3", "TRAIN.BATCH_SIZE_PER_GPU", "2",
            "TRAIN.TRAIN_INPUT_SIZE", "[64, 64]", *map(str, opts)]


def _video_argv(trees, out, *opts):
    return _argv("vmd_vmn_index_pretrained_30ep.yaml", out, "DATASET.PATH",
                 trees / "vmd", "TRAIN.LOAD_CKPT", trees / "index.pth",
                 "TRAIN.VAL_INPUT_SIZE", "[64, 96]", "TRAIN.IMAGE_FREQ", 1,
                 "TRAIN.TOTAL_STEPS", 2, *opts)


def test_train_cli_resumes_exactly(trees, tmp_path, monkeypatch):
    """The video trainer for two epochs of two steps (4 training samples
    at B = 2, S = 5), validation from epoch 1; then from the first epoch's
    checkpoint to the end: the second epoch's checkpoint is the same."""
    monkeypatch.setattr(train, "VAL_FROM_EPOCH", 1)
    full = train.main(_video_argv(trees, tmp_path / "full"))
    out = tmp_path / "full" / "vmd_vmn_index_pretrained_30ep_agg7"
    assert full["steps"] == 4 and full["step"] == 4
    names = set(os.listdir(out))
    assert {"checkpoint_1.pth", "checkpoint_2.pth", "best.pth",
            "config.yaml", "train_stats.json", "training_images",
            "val_images"} <= names
    assert len(os.listdir(out / "training_images")) == 4 * 7
    assert sorted(os.listdir(out / "val_images" / "epoch_1"))[:3] == [
        "00000_gt.png", "00000_pred.png", "00000_tri.png"]

    resumed = train.main(_video_argv(
        trees, tmp_path / "resumed", "TRAIN.LOAD_OPT",
        out / "checkpoint_1.pth"))
    assert resumed["steps"] == 2 and resumed["step"] == 4
    want = torch.load(out / "checkpoint_2.pth")
    got = torch.load(tmp_path / "resumed" / out.name / "checkpoint_2.pth")
    assert got["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["optimizer"]["state"][i][k], s[k]), (i, k)
    for k in ("radius", "dropout"):
        assert torch.equal(got["generator"][k], want["generator"][k]), k


def test_train_cli_pretrain_keeps_the_frozen_backbone(trees, tmp_path):
    """The TAM pretrain (cfgs/pretrain_vmn_index.yaml: FREEZE_BACKBONE)
    on the DIM pretrain items, one step from a .pth: the encoder's and the
    decoder's extract half's weights and statistics as loaded, the head's
    statistics moved."""
    stats = train.main(_argv(
        "pretrain_vmn_index.yaml", tmp_path, "DATASET.PATH", trees / "adobe",
        "TRAIN.LOAD_CKPT", trees / "index.pth", "TRAIN.MIN_EDGE_LENGTH", 96,
        "TRAIN.TOTAL_STEPS", 1, flags=("--driver", "single", "--dataset",
                                       "dim")))
    assert stats["step"] == 1
    loaded = torch.load(trees / "index.pth")
    trained = torch.load(tmp_path / "pretrain_vmn_index_agg7" /
                         "checkpoint_1.pth")["model"]
    frozen = ("encoder.", "decoder.decoder_layer6.", "decoder.decoder_layer5.",
              "decoder.decoder_layer4.")
    for k, v in loaded.items():
        if k.startswith(frozen):
            assert torch.equal(trained[k], v), k
    assert not torch.equal(
        trained["decoder.decoder_layer3.dconv.1.running_var"],
        loaded["decoder.decoder_layer3.dconv.1.running_var"])


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(trees, tmp_path):
    argv = _video_argv(trees, tmp_path)
    argv.remove("--device")
    argv.remove("cpu")
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(argv)


def test_train_cli_refuses_bf16(trees, tmp_path, monkeypatch):
    """(Named when the tool refused TRAIN.BF16.) TRAIN.BF16 reaches the
    trainer as ``compute_dtype=torch.bfloat16`` and ``--remat`` as
    ``remat=True``; by default neither is on. A run of both is
    tests/test_torch_train_remat.py's."""
    made = []

    class Made(Exception):
        pass

    def capture(*args, **kw):
        made.append(kw)
        raise Made

    monkeypatch.setattr(train, "MattingTrainer", capture)
    for extra, flags in (((), ()), (("TRAIN.BF16", "true"), ("--remat",))):
        argv = _video_argv(trees, tmp_path, *extra)
        with pytest.raises(Made):
            train.main(argv[:2] + list(flags) + argv[2:])
    assert [(kw["compute_dtype"], kw["remat"]) for kw in made] == [
        (None, False), (torch.bfloat16, True)]
