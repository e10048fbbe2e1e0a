"""The ``launches_per_step`` reader on canned profiles."""
from pathlib import Path

import pytest

from mattebench import harness
from mattebench.tests.test_mb_harness import canned_record

REPO = Path(__file__).resolve().parents[2]


def reader():
    return harness.load_module(
        REPO / "mattebench/metrics/launches_per_step.py",
        "reader_launches_per_step")


def test_launches_per_step_on_the_canned_record():
    # two operations launched inside the one encode span, one inside the
    # one decode span; the upload's copy (launched at 140) is in neither
    assert reader().read(canned_record()) == 3.0


def test_launches_per_step_is_per_span():
    """Two steps, the second at a clip's edge with two decodes (a flush):
    the count a step stays the encode's plus one decode's."""
    ops, launches, spans, corr = [], [], [], 0
    for name, t0, n in [("encode", 0.0, 5), ("decode", 10.0, 2),
                        ("encode", 20.0, 5), ("decode", 30.0, 2),
                        ("decode", 40.0, 2)]:
        spans.append(["mattebench." + name, t0, 5.0])
        for k in range(n):
            corr += 1
            launches.append([t0 + 1.0 + k, corr])
            ops.append(["k", 100.0 + corr, 1.0, corr])
    launches.append([50.0, 99])        # a launch outside every span
    ops.append(["k", 200.0, 1.0, 99])
    launches.append([12.0, 98])        # a runtime call that queued nothing
    record = {"profile": {"ops": ops, "launches": launches, "spans": spans}}
    assert reader().read(record) == pytest.approx(5.0 + 2.0)


@pytest.mark.parametrize("drop", ["profile", "encode", "decode", "ops"])
def test_launches_per_step_finds_nothing(drop):
    record = canned_record()
    prof = record["profile"]
    if drop == "profile":
        del record["profile"]
    elif drop == "ops":
        prof["ops"] = []
    else:
        prof["spans"] = [s for s in prof["spans"]
                         if s[0] != "mattebench." + drop]
    assert reader().read(record) is None
