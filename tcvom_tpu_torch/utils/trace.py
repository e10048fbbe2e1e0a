"""The port's host spans, on the profiler's timeline.

``with span("encoder"): ...`` records the range ``tcvom.encoder`` as a
``torch.profiler.record_function`` while a profiler records, so it lands
in the same trace as the device operations launched inside it, on the
same clock; a span's parent is the span open around it on the same
thread. With no profiler on, :func:`span` returns one shared null
context: an unguarded ``record_function`` costs some microseconds a call
even then, the guarded call a fraction of one. The guard reads the
profiler's own state, which ``torch.profiler.profile`` sets; nothing else
turns spans on.

A profiler records the main thread's spans; those of other threads
(``predict_test_folder``'s producer and writer) when it is started with
``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "tcvom."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``tcvom.<name>`` while a profiler records,
    and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
