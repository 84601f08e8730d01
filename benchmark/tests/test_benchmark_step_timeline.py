"""The readers of the served step's timeline (``step_gap_share``,
``starved_step_share``, ``submit_ms``, ``gc_pause_share``) on hand-made
windows: each sums the answered requests' ``timings`` fields and reads
None where no answer carries them."""

import sys

import pytest

from conftest import BENCH

sys.path.insert(0, BENCH)

from harness.readers import load_reader  # noqa: E402
from harness.window import Window  # noqa: E402


def window(timings, status=200):
    recs = [{"i": i, "t_send": 0.5, "t_due": 0.5, "t_done": 1.0 + i * 1e-3,
             "status": status, "timings": t}
            for i, t in enumerate(timings)]
    return Window(t_open=0.0, t_close=10.0, setup_s=0.0, records=recs,
                  counters={}, traffic=None, system=None)


CLOCKED = [
    {"decode_ms": 100.0, "steps": 10, "submit_ms": 5.0, "device_ms": 60.0,
     "gap_ms": 20.0, "starved_steps": 4, "gc_ms": 1.0},
    {"decode_ms": 300.0, "steps": 30, "submit_ms": 9.0, "device_ms": 120.0,
     "gap_ms": 0.0, "starved_steps": 2, "gc_ms": 5.0},
]


@pytest.mark.parametrize("name, want", [
    ("step_gap_share", 100.0 * 20.0 / 200.0),
    ("starved_step_share", 100.0 * 6 / 40),
    ("submit_ms", 14.0 / 40),
    ("gc_pause_share", 100.0 * 6.0 / 400.0),
])
def test_reader_sums_over_answered_requests(name, want):
    assert load_reader(name).read(window(CLOCKED)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["step_gap_share", "starved_step_share",
                                  "submit_ms", "gc_pause_share"])
def test_reader_reads_none_without_the_fields(name):
    r = load_reader(name)
    # No answers; answers from a program without the fields; failures.
    assert r.read(window([])) is None
    assert r.read(window([{"queue_ms": 1.0, "decode_ms": 5.0,
                           "total_ms": 6.0}])) is None
    assert r.read(window(CLOCKED, status=503)) is None


def test_device_fields_are_read_only_where_present():
    # A request without a device clock counts toward submit_ms only.
    mixed = CLOCKED + [{"decode_ms": 50.0, "steps": 10, "submit_ms": 6.0}]
    w = window(mixed)
    assert load_reader("starved_step_share").read(w) == pytest.approx(15.0)
    assert load_reader("step_gap_share").read(w) == pytest.approx(10.0)
    assert load_reader("submit_ms").read(w) == pytest.approx(20.0 / 50)
    assert load_reader("gc_pause_share").read(w) == pytest.approx(1.5)


def test_zero_denominators_read_none():
    zero = [{"decode_ms": 0.0, "steps": 0, "submit_ms": 0.0,
             "device_ms": 0.0, "gap_ms": 0.0, "starved_steps": 0,
             "gc_ms": 0.0}]
    for name in ("step_gap_share", "starved_step_share", "submit_ms",
                 "gc_pause_share"):
        assert load_reader(name).read(window(zero)) is None, name
