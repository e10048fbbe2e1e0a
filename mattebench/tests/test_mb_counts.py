"""The yardstick's counts against counts worked by hand at small shapes,
and against the numbers it gave before the kernels' work moved into
``mattebench/kernels/`` (pinned to the bit)."""
from __future__ import annotations

import json

import pytest
import torch

from mattebench import counts, harness, reference
from mattebench.kernels import edt_row, fam_window, group_norm
from mattebench.tests.tiny import REPO
from mattebench.traffic import closed_stream


def test_peaks_are_the_data_sheet():
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert counts.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert counts.bound_s(3.35e12, 1.0, 989e12) == 1.0
    assert counts.bound_s(1.0, 989e12, 989e12) == 1.0


def test_fam_counts_by_hand():
    # 3 x 3 grid, window 3, 2 channels, the whole grid unknown: corners see
    # 4 in-frame neighbours (themselves included), edges 6, the centre 9
    mask = torch.ones(1, 3, 3)
    nbytes, ops = fam_window.fam_counts(mask, 2, 3, 2)
    assert nbytes == (3 * 9 * 2 + 9) * 2
    assert ops == 4 * 2 * (4 * 4 + 4 * 6 + 9)
    # only the centre unknown, two rows of the batch
    mask = torch.zeros(2, 3, 3)
    mask[:, 1, 1] = 1
    nbytes, ops = fam_window.fam_counts(mask, 2, 3, 4)
    assert nbytes == (3 * 18 * 2 + 18) * 4
    assert ops == 2 * 4 * 2 * 9


def test_fam_mask_is_the_unknown_region_at_the_grid():
    tri = torch.zeros(1, 16, 16, 1, dtype=torch.uint8)
    tri[0, 0:8, 8:16] = 128
    tri[0, 8:16, 0:8] = 255
    mask = fam_window.fam_mask(tri, (2, 2))
    assert mask.tolist() == [[[False, True], [False, False]]]


def test_edt_counts_by_hand():
    assert edt_row.edt_rows(4, 1088) == 8704
    assert edt_row.edt_counts(10, 7) == (8 * 70, 16 * 70)


def test_flop_per_frame_by_hand():
    """Every convolution of FBA (one block a stage) at 64 x 64, as 2 x
    multiply-adds, at the grid of its output."""
    cfg = json.loads((REPO / "mattebench/configs/vmn_fba.json").read_text())
    cfg["layers"] = [1, 1, 1, 1]
    h = w = 64

    def grid(name: str) -> int:
        if name.startswith("encoder.conv1"):
            return (h // 2) * (w // 2)
        if name.startswith("encoder.layer1"):
            return (h // 4) * (w // 4)
        if name.startswith("encoder.layer2.0.conv1"):
            return (h // 4) * (w // 4)
        if name.startswith("decoder.ppm."):
            s = (1, 2, 3, 6)[int(name.split(".")[2])]
            return s * s
        if name.startswith("decoder.conv_up2"):
            return (h // 4) * (w // 4)
        if name.startswith("decoder.conv_up3"):
            return (h // 2) * (w // 2)
        if name.startswith("decoder.conv_up4"):
            return h * w
        return (h // 8) * (w // 8)

    enc = head = 0
    for name, shape in reference.spec(cfg).items():
        if len(shape) != 4:
            continue
        flop = 2 * shape[0] * shape[1] * shape[2] * shape[3] * grid(name)
        if name.startswith(("decoder.conv_up2", "decoder.conv_up3",
                            "decoder.conv_up4")):
            head += flop
        else:
            enc += flop
    assert counts.flop_per_frame(cfg, h, w) == (float(enc), float(head))


def test_gca_count_holds_the_attention_core():
    """GCA's encode count grows by the attention core's two products of
    N x N positions (N = h w / 256 at OS 16): at 128 x 128 against 64 x 64,
    convolutions x4, the core's products x16."""
    cfg = json.loads((REPO / "mattebench/configs/vmn_gca.json").read_text())
    small, _ = counts.flop_per_frame(cfg, 64, 64)
    large, _ = counts.flop_per_frame(cfg, 128, 128)

    def core(hw: int) -> float:
        n = (hw // 16) ** 2
        # correlation [n, 9 * 64] x [9 * 64, n]; reconstruction
        # [16 * 128, n] x [n, n]; twice an encode (encoder, decoder)
        return 2 * (2.0 * n * 9 * 64 * n + 2.0 * 16 * 128 * n * n)

    rest_small = small - core(64)
    rest_large = large - core(128)
    # the spectral norms' matrix-vector products do not grow with the frame
    assert abs(rest_large - 4 * rest_small) < 1e-3 * rest_large


def config(name: str) -> dict:
    return json.loads((REPO / "mattebench/configs" / f"{name}.json").read_text())


# What the yardstick read before its kernels' work moved to
# ``mattebench/kernels/`` and its methods' input to ``prepare``: FLOP of an
# encode and a head at 1088 x 1920, and a small seeded traffic's work
# (``program``) and FLOP a matte.
PINNED = {
    "vmn_fba": {"flop_per_frame": (2230794321920.0, 606901370880.0),
                "work": {"fam_window": [3543552.0, 33882112.0, 989e12],
                         "edt_row": [589824.0, 1179648.0, 33454080000000.0]},
                "flop_per_matte": 8401261909.333333},
    "vmn_gca": {"flop_per_frame": (1246206689280.0, 153078988800.0),
                "work": {"fam_window": [1774080.0, 16941056.0, 989e12]},
                "flop_per_matte": 2067466922.6666667},
}


def program(cfg: dict, height: int = 64, width: int = 96):
    """The parts of a ``harness.Program`` that the counts read, for two
    streams of a small traffic from a fixed seed."""
    params = json.loads((REPO / "mattebench/traffic/stream_b4.json").read_text())
    params.update(streams=2, height=height, width=width, pool_frames=3,
                  trimap={"unknown": [12, 52, 8, 88],
                          "foreground": [24, 40, 20, 70], "shift": 4})
    prog = object.__new__(harness.Program)
    prog.traffic = closed_stream.make(params, 2**31 + 11, "cpu")
    prog.config, prog.params = cfg, params
    return prog


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_yardstick_reads_what_it_read(name):
    cfg, want = config(name), PINNED[name]
    assert counts.flop_per_frame(cfg, 1088, 1920) == want["flop_per_frame"]
    prog = program(cfg)
    work = prog.work(3, [0, 1, 2, 3, 4, 239])
    assert {k: work[k] for k in want["work"]} == want["work"]
    assert prog.flop_per_matte() == want["flop_per_matte"]


def test_group_norm_counts_by_hand():
    """Every GroupNorm of FBA (one block a stage) at 64 x 64 in bf16: its
    input read and its output written, and the residual read at each
    bottleneck's last norm, in 2-byte elements."""
    cfg = config("vmn_fba")
    cfg["layers"] = [1, 1, 1, 1]
    g2, g4, g8 = 32 * 32, 16 * 16, 8 * 8
    encode = [(64, g2),                                   # the stem
              (64, g4), (64, g4), (256, g4), (256, g4),   # layer1 + shortcut
              (128, g4), (128, g8), (512, g8), (512, g8),
              (256, g8), (256, g8), (1024, g8), (1024, g8),
              (512, g8), (512, g8), (2048, g8), (2048, g8),
              (256, 1), (256, 4), (256, 9), (256, 36),    # the PPM
              (256, g8), (256, g8)]                       # conv_up1
    residual = [256 * g4, 512 * g8, 1024 * g8, 2048 * g8]
    head = [(256, g4), (64, g2)]
    enc_bytes = 2 * (2 * sum(c * n for c, n in encode) + sum(residual))
    head_bytes = 2 * 2 * sum(c * n for c, n in head)
    assert group_norm.per_frame(cfg, 64, 64, torch.bfloat16) == (
        float(enc_bytes), float(head_bytes))
    prog = program(cfg, 64, 64)
    assert prog.work(3, [0, 1])["group_norm"] == [
        2 * (3 * enc_bytes + 2 * head_bytes), 0.0, counts.PEAK_F32_ADD_MIN]
