"""edt_row: the row pass of FBA's exact Euclidean distance transform, one
call an encode over the background and foreground maps of every stream."""
from __future__ import annotations

from mattebench import counts

# The row pass's least exact algorithm: a min-plus convolution with the
# convex kernel d^2, done by a lower-envelope pass in which each value
# enters and leaves the envelope once: a few adds, a divide and compares
# each, counted high as 16 operations an output.
EDT_OPS_PER_OUTPUT = 16


def edt_counts(rows: int, width: int) -> tuple[float, float]:
    """Bytes and operations of one EDT row pass over ``rows`` rows of
    ``width``: each f32 input read once and each output written once,
    ``EDT_OPS_PER_OUTPUT`` operations an output."""
    return 8.0 * rows * width, float(EDT_OPS_PER_OUTPUT * rows * width)


def edt_rows(streams: int, height: int) -> int:
    """Rows of the row pass for one encode of ``streams`` frames: the
    background and the foreground maps of each."""
    return 2 * streams * height


def work(program, encodes: int, frames_decoded: list) -> list[float]:
    tp = program.traffic
    nbytes, ops = edt_counts(edt_rows(tp.streams, tp.height), tp.width)
    return [encodes * nbytes, encodes * ops, counts.PEAK_F32_ADD_MIN]
