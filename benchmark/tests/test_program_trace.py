"""The readers of the program's record (``benchlib/program_trace.py`` and
the metrics that use it) against a hand-built record and trace."""
import importlib.util

import pytest

from benchlib import program_trace, trace
from benchlib.harness import Reading
from conftest import BENCH

# a unit's call 0-100 and its result 100-120 in a window 0-130; the device
# runs 30-35, 45-50, 70-72 and 90-110
OPS = [trace.DeviceOp("k", a, b, "kernel") for a, b in ((30, 35), (45, 50), (70, 72), (90, 110))]
HARNESS = [("bench.call", 0, 100), ("bench.result", 100, 120)]
SPANS = [("extract.pad", "pipeline.prepare", 10, 20), ("pipeline.prepare", None, 5, 40),
         ("pipeline.quantize.read", "pipeline.quantize", 60, 75),
         ("pipeline.quantize", None, 40, 80), ("graphs.replay", None, 80, 95)]
REC = {"spans": SPANS,
       "counters": {"pipeline.quantize.rows_valid": 30, "pipeline.quantize.rows_padded": 40,
                    "extract.rows_valid": 9, "extract.rows_padded": 12},
       "stages": [{"graph": "g", "at_ns": 85, "ms": {"pipeline.forward": f, "registration.nn": 0.01},
                   "total_ms": f + 0.01} for f in (2.0, 3.0, 7.0)]}


def _run():
    return Reading(trace.Trace(OPS, HARNESS, (0, 130), 1), [], {})


def test_a_gap_across_two_spans_is_split_and_the_innermost_wins():
    run = _run()
    assert program_trace.idle_gaps(run) == [(0, 30), (35, 45), (50, 70), (72, 90), (110, 130)]
    table, share = program_trace.idle_table(run, REC)
    assert table == pytest.approx({
        "bench.call": 5e-6,                 # 0-5: the call, before any program span
        "pipeline.prepare": 20e-6,          # 5-10, 20-30, then 35-40 of the gap 35-45
        "extract.pad": 10e-6,               # 10-20 inside prepare: the innermost wins
        "pipeline.quantize": 20e-6,         # 40-45 of the gap 35-45, 50-60, 75-80
        "pipeline.quantize.read": 13e-6,    # 60-70, 72-75
        "graphs.replay": 10e-6,             # 80-90
        "bench.result": 10e-6,              # 110-120
        "outside a span": 10e-6})           # 120-130
    assert share == pytest.approx(100 * 83 / 98)


def test_the_idle_under_a_span_counts_its_nested_spans():
    assert program_trace.idle_ms_under(_run(), REC, "pipeline.prepare") == pytest.approx(30e-6)
    assert program_trace.idle_ms_under(_run(), REC, "pipeline.draws") is None


def test_reads_stages_and_padding():
    run = _run()
    read = program_trace.median_ms_in_units(run, REC, lambda n: n.endswith(".read"))
    assert read == pytest.approx(15e-6)
    assert program_trace.stage_ms(run, REC, "pipeline.forward") == 3.0
    assert program_trace.stage_ms(run, REC, "registration.ransac") is None
    assert program_trace.pad_share(REC, "pipeline.quantize") == pytest.approx(25.0)
    assert program_trace.pad_share(REC, "trainer.stage") is None


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


NEW = ("prepare_idle_ms.pair", "read_wait_ms.pair", "forward_ms.pair", "ransac_ms.pair",
       "pad_share.pair", "forward_ms.kitti", "ransac_ms.kitti", "pad_share.kitti",
       "backward_ms.train", "read_wait_ms.extract", "copy_out_ms.extract", "pad_share.extract")


@pytest.mark.parametrize("name", NEW)
def test_a_reader_gives_none_where_the_program_keeps_no_record(name, monkeypatch):
    from imfnet_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "record")
    assert _reader(name)(_run()) is None


def test_the_readers_read_the_program_record(monkeypatch):
    monkeypatch.setattr(program_trace, "record", lambda: REC)
    run = _run()
    got = {n: _reader(n)(run) for n in NEW}
    assert got["prepare_idle_ms.pair"] == pytest.approx(30e-6)
    assert got["read_wait_ms.pair"] == pytest.approx(15e-6)
    assert got["forward_ms.pair"] == 3.0 and got["pad_share.pair"] == pytest.approx(25.0)
    assert got["pad_share.extract"] == pytest.approx(25.0)
    assert [got[n] for n in ("ransac_ms.pair", "forward_ms.kitti", "ransac_ms.kitti",
                             "pad_share.kitti", "backward_ms.train", "read_wait_ms.extract",
                             "copy_out_ms.extract")] == [None] * 7
    assert any("under a program span or bench.result" in m for m in run.notes)
