"""The port's PNG codec against OpenCV, and its VideoMatting108 readers
(the flow of both val paths included) against the JAX package's, on the
CPU."""
import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from tcvom_tpu.data import vmd as JV
from tcvom_tpu_torch.data import vmd as TV
from tcvom_tpu_torch.data.loader import make_loader
from tcvom_tpu_torch.tools.make_fake_dataset import make
from tcvom_tpu_torch.utils import imageio as IO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = (IO.IMREAD_UNCHANGED, IO.IMREAD_COLOR, IO.IMREAD_GRAYSCALE)


def _image(kind: str, rng, h=37, w=53):
    return {"gray": lambda: rng.randint(0, 256, (h, w), np.uint8),
            "bgr": lambda: rng.randint(0, 256, (h, w, 3), np.uint8),
            "bgra": lambda: rng.randint(0, 256, (h, w, 4), np.uint8),
            "u16": lambda: rng.randint(0, 65536, (h, w, 3)).astype(np.uint16),
            "u16gray": lambda: rng.randint(0, 65536, (h, w)).astype(np.uint16),
            }[kind]()


def _read_both(path):
    """(flag, cv2's array, the codec's array or its error) for each flag."""
    with open(path, "rb") as f:
        data = f.read()
    for flag in FLAGS:
        try:
            mine = IO.decode_png(data, flag, path)
        except ValueError as e:
            mine = e
        yield flag, cv2.imread(path, flag), mine


def _same(flag, want, got, color: bool):
    if isinstance(got, ValueError):
        # the one refusal: a color image read as grayscale
        assert color and flag == IO.IMREAD_GRAYSCALE, got
        assert "cv2" in str(got)
        return
    assert got.dtype == want.dtype and got.shape == want.shape, flag
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "u16", "u16gray"])
@pytest.mark.parametrize("writer", ["codec", "cv2"])
def test_codec_matches_cv2(tmp_path, kind, writer):
    """Written by one side, read by both under every flag: pixels
    identical, and the codec reads back exactly what it wrote."""
    img = _image(kind, np.random.RandomState(len(kind)))
    path = str(tmp_path / "x.png")
    if writer == "codec":
        with open(path, "wb") as f:
            f.write(IO.encode_png(img))
    else:
        cv2.imwrite(path, img)
    for flag, want, got in _read_both(path):
        _same(flag, want, got, kind in ("bgr", "bgra", "u16"))
        if flag == IO.IMREAD_UNCHANGED:
            np.testing.assert_array_equal(got, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(raw: np.ndarray, kinds, bpp: int) -> bytes:
    """Filter row i of ``raw`` [H, rowbytes] with PNG filter ``kinds[i]``
    (or ``kinds`` for every row), byte by byte, as the PNG specification
    defines the filters."""
    out = bytearray()
    prior = [0] * raw.shape[1]
    for i, row in enumerate(raw.tolist()):
        kind = kinds if isinstance(kinds, int) else kinds[i]
        out.append(kind)
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            c = prior[x - bpp] if x >= bpp else 0
            pred = (0, a, prior[x], (a + prior[x]) // 2,
                    _paeth(a, prior[x], c))[kind]
            out.append((v - pred) % 256)
        prior = row
    return bytes(out)


def _png(ihdr, body: bytes, palette: bytes = b"") -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (IO.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + (chunk(b"PLTE", palette) if palette else b"")
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("depth", [8, 16])
def test_codec_reads_every_filter_type(tmp_path, kind, depth):
    """A hand-built RGBA PNG whose rows all use filter ``kind``: the codec
    and cv2 both give back the image."""
    rng = np.random.RandomState(kind)
    h, w = 9, 11
    img = rng.randint(0, 1 << depth, (h, w, 4)).astype(
        np.uint8 if depth == 8 else np.uint16)
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                               ).view(np.uint8).reshape(h, -1)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png((w, h, depth, 6, 0, 0, 0),
                     _filter_rows(raw, kind, 4 * depth // 8)))
    bgra = img[..., [2, 1, 0, 3]]
    for flag, want, got in _read_both(path):
        _same(flag, want, got, color=True)
    np.testing.assert_array_equal(IO.decode_png(open(path, "rb").read(), -1),
                                  bgra)


def test_codec_mixed_filters_and_low_depths(tmp_path):
    """Rows alternating through all five filters; a 1-bit and a 4-bit gray
    image; a palette image."""
    rng = np.random.RandomState(7)
    h, w = 12, 13
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    body = _filter_rows(img.reshape(h, -1), [i % 5 for i in range(h)], 3)
    cases = {"mixed": (_png((w, h, 8, 2, 0, 0, 0), body), img[..., ::-1])}
    for depth in (1, 4):
        v = rng.randint(0, 1 << depth, (h, w)).astype(np.uint8)
        bits = np.unpackbits(v[..., None], axis=-1)[..., 8 - depth:]
        packed = np.packbits(bits.reshape(h, -1), axis=1)
        rows = b"".join(b"\0" + r.tobytes() for r in packed)
        cases[f"gray{depth}"] = (_png((w, h, depth, 0, 0, 0, 0), rows),
                                 v * (255 // ((1 << depth) - 1)))
    pal = rng.randint(0, 256, (20, 3), np.uint8)
    idx = rng.randint(0, 20, (h, w)).astype(np.uint8)
    cases["palette"] = (_png((w, h, 8, 3, 0, 0, 0),
                             _filter_rows(idx, 1, 1), pal.tobytes()),
                        pal[idx][..., ::-1])
    for name, (data, want) in cases.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(IO.decode_png(data, -1), want)
        for flag, ref, got in _read_both(path):
            _same(flag, ref, got, color=name in ("mixed", "palette"))


def test_imread_errors(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        IO.imread(str(tmp_path / "missing.png"))
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, np.zeros((4, 4, 3), np.uint8))
    assert IO.codec() == "cv2"
    monkeypatch.setattr(IO, "cv2", None)
    assert IO.codec() == "zlib"
    with pytest.raises(ValueError, match=r"x\.jpg.*cv2"):
        IO.imread(jpg)
    with pytest.raises(ValueError, match="cv2"):
        IO.imwrite(jpg, np.zeros((4, 4), np.uint8))
    png = str(tmp_path / "x.png")
    IO.imwrite(png, np.full((4, 5, 3), 7, np.uint8))       # the codec
    assert IO.imread(png).shape == (4, 5, 3)
    assert cv2.imread(png, -1).tolist() == np.full((4, 5, 3), 7).tolist()


@pytest.fixture(scope="module")
def vmd_root(tmp_path_factory):
    """The same fake tree written by both packages' makers (BG as PNG)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_fake_dataset as jax_maker
    roots = {}
    for name, maker in (("jax", jax_maker.make), ("port", make)):
        roots[name] = str(tmp_path_factory.mktemp(name))
        maker(roots[name], frames=4, hw=(40, 56), seed=3)
    flow = os.path.join(roots["jax"], "flow_png", "clip_b",
                        "flow_00001_00002.png")
    x = cv2.imread(flow, -1)
    x[5:9, 7:20] = (65000, 300, 0)          # negative dx, invalid
    x[20:25, 30:40] = (120, 65300, 255)     # negative dy, valid
    cv2.imwrite(flow, x)
    return roots


def test_fake_trees_are_the_same(vmd_root):
    for dirpath, _, files in os.walk(vmd_root["port"]):
        rel = os.path.relpath(dirpath, vmd_root["port"])
        for fn in files:
            a = os.path.join(vmd_root["jax"], rel, fn)
            b = os.path.join(dirpath, fn)
            if fn.endswith(".png") and "flow_00001_00002" not in fn:
                np.testing.assert_array_equal(cv2.imread(b, -1),
                                              cv2.imread(a, -1), err_msg=fn)
            elif fn.endswith((".json", ".txt")):
                assert open(a).read() == open(b).read(), fn


def test_read_flow_png_matches_jax(vmd_root):
    path = os.path.join(vmd_root["jax"], "flow_png", "clip_b",
                        "flow_00001_00002.png")
    want = JV.read_flow_png(path)
    with open(path, "rb") as f:
        data = f.read()
    got = TV.read_flow_png(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(want).any() and (want < 0).any()
    # the codec decodes the 16-bit flow PNG as cv2 does
    np.testing.assert_array_equal(IO.decode_png(data, -1), cv2.imread(path, -1))


def test_parse_samples_matches_jax():
    corr = {f"v{v}/{i:05d}.png": "" for v in range(2) for i in range(6)}
    for length in (1, 3, 5):
        assert (TV.parse_samples(["v0", "v1"], corr, length)
                == JV.parse_samples(["v0", "v1"], corr, length))


@pytest.mark.parametrize("no_flow,length", [(True, 3), (False, 5)])
def test_val_items_match_jax(vmd_root, no_flow, length):
    root = vmd_root["jax"]
    kw = dict(data_root=root, image_shape=(48, 64), mode="val",
              precomputed_val=root, sample_length=length, no_flow=no_flow)
    want, got = JV.VideoMattingDataset(**kw), TV.VideoMattingDataset(**kw)
    assert got.samples == want.samples and len(got) == 4
    for i in range(len(got)):
        w, g = want[i], got[(0, i)]
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    batches = list(make_loader(got, 3))
    assert [len(b["idx"]) for b in batches] == [3, 1]
    np.testing.assert_array_equal(batches[1]["a"][0], got[(0, 3)]["a"])


def test_train_mode_points_to_the_roadmap(vmd_root, tmp_path):
    """Validation items of the resize path with flow (``no_flow=False``,
    no precomputed tree: each flow resized with its frames by
    flow_crop_and_resize) equal to the JAX package's, S = 3 and 5, on a
    copy of the tree whose flow PNGs hold random int16 flow, +-60 px
    jumps and a third of the pixels invalid."""
    root = str(tmp_path / "vmd")
    shutil.copytree(vmd_root["jax"], root)
    rng = np.random.RandomState(11)
    flows = sorted(os.path.join(d, f) for d, _, fs in
                   os.walk(os.path.join(root, "flow_png")) for f in fs)
    for path in flows:
        x = cv2.imread(path, -1)
        h, w = x.shape[:2]
        flow = rng.normal(0, 1.5, (h, w, 2)) + rng.uniform(-20, 20, 2)
        flow[rng.rand(h, w) < 0.03] += 60.0
        x[..., :2] = np.round(flow * 100).astype(np.int16).view(np.uint16)
        x[..., 2] = np.where(rng.rand(h, w) < 0.3, 0, 255)
        cv2.imwrite(path, x)
    for length in (3, 5):
        kw = dict(data_root=root, image_shape=(48, 40), mode="val",
                  sample_length=length, no_flow=False)
        want, got = JV.VideoMattingDataset(**kw), TV.VideoMattingDataset(**kw)
        for i in range(len(got)):
            w, g = want[i], got[(0, i)]
            assert set(g) == set(w) and g["wb"].shape == (length, 48, 40, 2)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.isfinite(g["wb"][length // 2]).any()
            assert np.isnan(g["wb"][length // 2]).any()
