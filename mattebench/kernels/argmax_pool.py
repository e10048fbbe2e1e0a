"""argmax_pool: DIM's 2x2 argmax max pools and max unpools, at the cell's
shapes and dtype, whatever implements them.

Bytes: each pool reads its input and writes a quarter as many pooled
values and uint8 indices; each unpool reads its input and its uint8
indices and writes an output four times as large. Both are counted over
the method's own pools and unpools (its ``recording_pools``, on the meta
device): five pools and two unpools an encode, three unpools a head. The
functions are bound by their bytes: a few compares an element, so no
operations are counted.
"""
from __future__ import annotations

import functools
import json

import torch

from mattebench import counts
from mattebench.reference import common


def per_frame(config: dict, height: int, width: int,
              dtype: torch.dtype) -> tuple[float, float]:
    """Bytes of the pools and unpools of one frame's encode and of one
    matte's head, in ``dtype``."""
    return frame_bytes(json.dumps(config, sort_keys=True), height, width,
                       dtype)


@functools.lru_cache(maxsize=4)
def frame_bytes(config_json: str, height: int, width: int,
                dtype: torch.dtype) -> tuple[float, float]:
    """:func:`per_frame` of a configuration given as JSON, counted once a
    run."""
    config = json.loads(config_json)
    model, sd, pre = counts.meta_frame(config, height, width)
    ar = common.Arith(dtype)
    with torch.no_grad(), model.recording_pools() as enc_calls:
        enc, feat = model.encode(ar, sd, pre["x"], pre["extras"])
        _, _, v = common.fam_projections(ar, sd, feat)
    with torch.no_grad(), model.recording_pools() as head_calls:
        model.head(ar, sd, enc, v)

    def nbytes(calls) -> float:
        # the larger side's values, the smaller side's (a quarter) and its
        # one-byte indices
        return float(sum(n * size + n // 4 * (size + 1) for n, size in calls))

    return nbytes(enc_calls), nbytes(head_calls)


def work(program, encodes: int, frames_decoded: list) -> list[float]:
    tp = program.traffic
    enc, head = per_frame(program.config, tp.height, tp.width, tp.dtype)
    return [tp.streams * (encodes * enc + len(frames_decoded) * head), 0.0,
            counts.PEAK_F32_ADD_MIN]
