"""The closed-loop matting stream: the one generator of the benchmark's
traffic mixes (``traffic/<mix>.json`` with ``"kind": "closed_stream"``).

``streams`` videos are matted together, one frame of each per step, as
fast as the card allows: the next frames go in once the mattes of
``inflight`` steps back are on the host. Clips are ``clip_frames`` long;
each stream cycles through a pool of ``pool_frames`` frames, made at
set-up from the seed on the device and held in pinned host memory.

A frame is uniform noise; its trimap is ``unknown`` (rows ``[y0, y1)``,
columns ``[x0, x1)``: 128) around a ``foreground`` core (255) on
background (0), both boxes moved together by a draw of up to ``shift``
pixels each way, per frame. The same seed gives the same pools.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ClosedStream:
    """The pools and the schedule of one run."""

    def __init__(self, params: dict, seed: int, device):
        self.params = params
        self.streams = params["streams"]
        self.height, self.width = params["height"], params["width"]
        self.clip_frames = params["clip_frames"]
        self.pool_frames = params["pool_frames"]
        self.inflight = params["inflight"]
        self.dtype = DTYPES[params["dtype"]]
        shape = (self.pool_frames, self.streams, self.height, self.width)
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        frames = torch.randint(0, 256, shape + (3,), generator=gen, device=dev,
                               dtype=torch.uint8)
        shift = params["trimap"]["shift"]
        moves = torch.randint(-shift, shift + 1, shape[:2] + (2,),
                              generator=torch.Generator().manual_seed(seed))
        trimaps = torch.zeros(shape + (1,), dtype=torch.uint8, device=dev)
        for i in range(self.pool_frames):
            for s in range(self.streams):
                dy, dx = moves[i, s].tolist()
                for box, value in (("unknown", 128), ("foreground", 255)):
                    y0, y1, x0, x1 = params["trimap"][box]
                    trimaps[i, s, y0 + dy:y1 + dy, x0 + dx:x1 + dx] = value
        self.frames, self.trimaps = (_host(t) for t in (frames, trimaps))

    def pool_index(self, clip_frame: int) -> int:
        return clip_frame % self.pool_frames

    def batch(self, clip_frame: int):
        """The host frames and trimaps of every stream at ``clip_frame``:
        ``[streams, H, W, 3]`` and ``[streams, H, W, 1]`` uint8, contiguous
        views of the pinned pools (so each uploads in one copy)."""
        p = self.pool_index(clip_frame)
        return self.frames[p], self.trimaps[p]

    def window(self, clip_frame: int, last: int) -> tuple[int, int, int]:
        """Clip frames (previous, current, next) of the matte of
        ``clip_frame`` in a clip whose last frame is ``last``: reflected
        at the clip's edges, as the stream reflects them."""
        if last == 0:
            return 0, 0, 0
        prev = clip_frame - 1 if clip_frame > 0 else 1
        nxt = clip_frame + 1 if clip_frame < last else last - 1
        return prev, clip_frame, nxt


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` in pinned host memory (a CPU tensor stays as it is)."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def make(params: dict, seed: int, device) -> ClosedStream:
    return ClosedStream(params, seed, device)
