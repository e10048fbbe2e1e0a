"""cv2/numpy augmentations of the training data (the port's copy of
tcvom_tpu/data/augment.py), in place of the reference's imgaug pipeline
(dataset/VMD.py:52-57, dataset/DIM.py:54-58): hue/saturation multiply,
gamma contrast, hue shift, JPEG artifacts, with the same truncated
normals, on uint8 BGR images; and the align-corners bilinear resize of
the crops.

The colour and JPEG augmentations need OpenCV (cv2); where it does not
import they raise an error that names the augmentation. The draws
(:meth:`PixelAug.sample`, :meth:`JpegAug.sample`) and the resize need only
numpy.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    cv2.setNumThreads(0)     # same fork-safety measure as train_ddp.py:10
except ImportError:
    cv2 = None


def need_cv2(what: str):
    """The cv2 module, or an ImportError that names ``what`` needs it."""
    if cv2 is None:
        raise ImportError(f"{what} needs OpenCV (cv2), which does not "
                          "import here")
    return cv2


def truncated_normal(rng: np.random.RandomState, mean, std, low, high):
    """A normal draw re-drawn until it lies in [low, high] (100 tries,
    then clipped)."""
    for _ in range(100):
        v = rng.normal(mean, std)
        if low <= v <= high:
            return v
    return float(np.clip(v, low, high))


class PixelAug:
    """MultiplyHueAndSaturation + GammaContrast + AddToHue with the
    reference's truncated-normal parameters: sample once, apply to every
    frame of a clip."""

    def __init__(self, rng: np.random.RandomState):
        self.rng = rng

    def sample(self) -> dict:
        return {
            "hs_mul": truncated_normal(self.rng, 1.0, 0.2, 0.5, 1.5),
            "gamma": truncated_normal(self.rng, 1.0, 0.2, 0.5, 1.5),
            # imgaug's hue range [-255, 255] is +-180 degrees; cv2's hue is
            # [0, 180), so the shift is scaled by 180/255
            "hue_add": truncated_normal(self.rng, 0.0, 10.0, -51.0, 51.0),
        }

    @staticmethod
    def apply(img_bgr_u8: np.ndarray, p: dict) -> np.ndarray:
        cv = need_cv2("PixelAug (hue, saturation and gamma)")
        hsv = cv.cvtColor(img_bgr_u8, cv.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] * p["hs_mul"]
                       + p["hue_add"] * (180.0 / 255.0)) % 180.0
        hsv[..., 1] = np.clip(hsv[..., 1] * p["hs_mul"], 0, 255)
        img = cv.cvtColor(hsv.astype(np.uint8), cv.COLOR_HSV2BGR)
        img = np.clip(((img / 255.0) ** p["gamma"]) * 255.0, 0, 255)
        return img.astype(np.uint8)


class JpegAug:
    """Sometimes(0.6, JpegCompression(70..99)) (dataset/VMD.py:57)."""

    def __init__(self, rng: np.random.RandomState, prob: float = 0.6,
                 compression=(70, 99)):
        self.rng = rng
        self.prob = prob
        self.compression = compression

    def sample(self):
        if self.rng.rand() >= self.prob:
            return None
        return int(self.rng.randint(self.compression[0],
                                    self.compression[1] + 1))

    @staticmethod
    def apply(img_bgr_u8: np.ndarray, compression) -> np.ndarray:
        if compression is None:
            return img_bgr_u8
        cv = need_cv2("JpegAug (JPEG compression)")
        _, enc = cv.imencode(".jpg", img_bgr_u8,
                             [int(cv.IMWRITE_JPEG_QUALITY), 100 - compression])
        return cv.imdecode(enc, cv.IMREAD_COLOR)


def resize_bilinear_ac(img: np.ndarray, out_hw, round_floor_half: bool = True
                       ) -> np.ndarray:
    """Bilinear resize with align_corners=True, then floor(x + 0.5)
    (``round_floor_half``), the reference's img_crop_and_resize
    (dataset/VMD.py:62-66). ``img`` is [H, W, C]; returns f32."""
    h, w = img.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        out = img.astype(np.float32)
    else:
        ys = np.linspace(0, h - 1, oh) if oh > 1 else np.zeros(1)
        xs = np.linspace(0, w - 1, ow) if ow > 1 else np.zeros(1)
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = (ys - y0).astype(np.float32)[:, None, None]
        wx = (xs - x0).astype(np.float32)[None, :, None]
        imgf = img.astype(np.float32)
        out = ((imgf[y0][:, x0] * (1 - wy) * (1 - wx))
               + (imgf[y0][:, x1] * (1 - wy) * wx)
               + (imgf[y1][:, x0] * wy * (1 - wx))
               + (imgf[y1][:, x1] * wy * wx))
    if round_floor_half:
        out = np.floor(out + 0.5)
    return out
