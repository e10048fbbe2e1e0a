"""group_norm: the GroupNorm function of the reference's norms, with the
residual that a block adds after its last norm, at the cell's shapes and
dtype, whatever implements it.

Bytes: each norm's input read and its output written once, and the
residual read where the block adds one after the norm (the bottlenecks'
``bn3``); the parameters are left out. The function is bound by its
bytes: its few operations an element (the statistics' sums, one
multiply-add, the add and the activation) would take at most a fifth of
the bytes' time at the f32 peak, so none are counted.
"""
from __future__ import annotations

import functools
import json

import torch

from mattebench import counts
from mattebench.reference import common


def per_frame(config: dict, height: int, width: int,
              dtype: torch.dtype) -> tuple[float, float]:
    """Bytes of the norms of one frame's encode (the network and the
    FAM's projections) and of one matte's head, recorded over the
    reference on the meta device in ``dtype``."""
    return frame_bytes(json.dumps(config, sort_keys=True), height, width,
                       dtype)


@functools.lru_cache(maxsize=4)
def frame_bytes(config_json: str, height: int, width: int,
                dtype: torch.dtype) -> tuple[float, float]:
    """:func:`per_frame` of a configuration given as JSON, counted once a
    run."""
    model, sd, pre = counts.meta_frame(json.loads(config_json), height, width)
    ar = common.Arith(dtype)
    with torch.no_grad(), common.recording_norms() as enc_norms:
        enc, feat = model.encode(ar, sd, pre["x"], pre["extras"])
        _, _, v = common.fam_projections(ar, sd, feat)
    with torch.no_grad(), common.recording_norms() as head_norms:
        model.head(ar, sd, enc, v)

    def nbytes(norms) -> float:
        return float(sum(n * size * (3 if residual else 2)
                         for n, size, residual in norms))

    return nbytes(enc_norms), nbytes(head_norms)


def work(program, encodes: int, frames_decoded: list) -> list[float]:
    tp = program.traffic
    enc, head = per_frame(program.config, tp.height, tp.width, tp.dtype)
    return [tp.streams * (encodes * enc + len(frames_decoded) * head), 0.0,
            counts.PEAK_F32_ADD_MIN]
