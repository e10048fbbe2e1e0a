"""Image files with the semantics the JAX package takes from OpenCV.

``imread(path, flags)`` and ``imwrite(path, array)`` behave as ``cv2.imread``
and ``cv2.imwrite`` do on PNG files: channels in BGR(A) order, 8- or 16-bit
samples, the flags ``IMREAD_COLOR`` (3-channel BGR uint8),
``IMREAD_GRAYSCALE`` (``[H, W]`` uint8) and ``IMREAD_UNCHANGED`` (the file's
own channels and depth). Unlike ``cv2.imread``, a missing file raises.

They use ``cv2`` when it can be imported. Otherwise they use the PNG codec
below, written on ``zlib`` and numpy (:func:`codec` says which runs):

- the writer emits filter type 0 on the first row and 2 (Up) on the others,
  so that reading its own files is vectorised;
- the reader decodes all five filter types: None, Sub and Up vectorised,
  Average and Paeth one row at a time (seconds for a 1080p frame; only
  files written by another encoder take that path);
- bit depths 1-16, gray, gray + alpha, RGB, RGBA and palette images; not
  interlaced images, transparency chunks, or a color image read as
  grayscale (libpng's conversion is not reproduced): those raise.

Any other format without ``cv2`` raises an error that names the file.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

try:
    import cv2
    cv2.setNumThreads(0)
except ImportError:
    cv2 = None

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by PNG color type
_ZLIB_LEVEL = 1                                # cv2's default PNG level


def codec() -> str:
    """The backend :func:`imread` and :func:`imwrite` use: 'cv2' or
    'zlib'."""
    return "zlib" if cv2 is None else "cv2"


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if cv2 is not None:
        out = cv2.imread(path, flags)
        if out is None:
            raise ValueError(f"{path}: cv2 could not decode the file")
        return out
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file; reading it needs OpenCV "
                         "(cv2)")
    return decode_png(data, flags, path)


def imwrite(path: str, img: np.ndarray) -> None:
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise ValueError(f"{path}: cv2 could not write the file")
        return
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG files are written without "
                         "OpenCV (cv2)")
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of ``img``: uint8 or uint16, ``[H, W]``, ``[H, W, 1]``,
    BGR ``[H, W, 3]`` or BGRA ``[H, W, 4]``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        color = 2 if img.shape[2] == 3 else 6
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    else:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, not {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"),
                                           copy=False)).view(np.uint8)
    rows = rows.reshape(h, -1)
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2                             # Up
    filtered[0, 0] = 0                             # None
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), _ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _unfilter_row(kind: int, cur: bytearray, prior, bpp: int) -> None:
    """Average (3) or Paeth (4) on one row, in place."""
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prior[x]
        if kind == 3:
            cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF


def _unfilter(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``rows`` [H, rowbytes] (uint8)."""
    h, n = rows.shape
    out = rows.copy()
    i = 0
    while i < h:
        kind = int(kinds[i])
        j = i + 1
        if kind in (0, 1):
            while j < h and kinds[j] in (0, 1):
                j += 1
            sub = np.nonzero(kinds[i:j] == 1)[0] + i
            if len(sub):
                grp = out[sub].reshape(len(sub), n // bpp, bpp)
                out[sub] = np.cumsum(grp, axis=1, dtype=np.uint8).reshape(
                    len(sub), n)
        elif kind == 2:
            while j < h and kinds[j] == 2:
                j += 1
            run = np.cumsum(out[i:j], axis=0, dtype=np.uint8)
            out[i:j] = run + out[i - 1] if i else run
        elif kind in (3, 4):
            cur = bytearray(out[i].tobytes())
            prior = out[i - 1].tobytes() if i else bytes(n)
            _unfilter_row(kind, cur, prior, bpp)
            out[i] = np.frombuffer(cur, np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        i = j
    return out


def _to_gray(img: np.ndarray, color: int, name: str) -> np.ndarray:
    if color in (0, 4):
        return img[..., 0]
    raise ValueError(f"{name}: a color PNG read as grayscale needs OpenCV "
                     "(cv2); libpng's conversion is not reproduced")


def decode_png(data: bytes, flags: int = IMREAD_COLOR,
               name: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode`` of PNG ``data`` with ``flags``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, ihdr, palette = len(PNG_SIGNATURE), [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError(f"{name}: PNG transparency (tRNS) needs OpenCV "
                             "(cv2)")
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{name}: interlaced PNG needs OpenCV (cv2)")
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{name}: PNG color type {color}, depth {depth}")
    ch = _CHANNELS[color]
    rowbytes = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (rowbytes + 1)].reshape(h, rowbytes + 1)
    rows = _unfilter(raw[:, 1:], raw[:, 0], max(1, ch * depth // 8))

    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = rows.reshape(h, w, ch)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = (bits.reshape(h, w, depth) * weights).sum(-1, dtype=np.uint8)
        if color == 0:                        # scaled to 0..255, as libpng
            img = img * np.uint8(255 // ((1 << depth) - 1))
        img = img[..., None]
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        img, color = palette[img[..., 0]], 2

    if flags == IMREAD_GRAYSCALE:
        g = _to_gray(img, color, name)
        return (g >> 8).astype(np.uint8) if g.dtype == np.uint16 else g
    if flags == IMREAD_COLOR:
        img = img[..., :1].repeat(3, -1) if color in (0, 4) else img[..., :3]
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        return np.ascontiguousarray(img[..., ::-1])
    if flags != IMREAD_UNCHANGED:
        raise ValueError(f"imread flag {flags}")
    if color == 0:
        return img[..., 0]
    if color == 4:                            # gray + alpha -> BGRA
        return np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], -1)
    return np.ascontiguousarray(
        np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1))
