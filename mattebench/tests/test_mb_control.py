"""The control at a size a CPU test run holds: the reference computed in
the next precision below the cells' bf16 (bf16 with fp8 operands,
``reference.FP8``), put in the program's place, fails the configuration's
bf16 limits, as it does on the card at the cells' size (``control.py``)."""
from __future__ import annotations

import json

import pytest
import torch

from mattebench import check, reference, weights
from mattebench.tests.tiny import REPO, TRIMAP
from mattebench.traffic import closed_stream


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_gca"])
def test_the_control_fails_the_limits(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        cfg = json.loads((REPO / "mattebench/configs" / f"{name}.json").read_text())
        limits = cfg["limits"]["bfloat16"]
        tp = closed_stream.make(
            {"streams": 2, "height": 64, "width": 64, "dtype": "bfloat16",
             "clip_frames": 5, "pool_frames": 4, "inflight": 2,
             "trimap": TRIMAP}, 2**31 + 3, "cpu")
        sd = weights.make_state_dict(cfg, 2**31 + 3, "cpu", tp.batch(0))
        samples = [check.Sample(f, 4, None) for f in (0, 2, 4)]
        want = check.reference_mattes(cfg, sd, tp, samples, "cpu")
        ctl = check.reference_mattes(cfg, sd, tp, samples, "cpu", reference.FP8)
        stand_in = [check.Sample(s.clip_frame, s.last, m)
                    for s, m in zip(samples, ctl)]
        result = check.compare(stand_in, want, tp, limits)
        assert not check.passed(result["checks"], result["mattes"]), result
        same = check.compare([check.Sample(s.clip_frame, s.last, m)
                              for s, m in zip(samples, want)], want, tp, limits)
        assert check.passed(same["checks"], same["mattes"])
    finally:
        torch.set_num_threads(threads)
