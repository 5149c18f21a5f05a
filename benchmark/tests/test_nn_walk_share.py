"""The readers of kernel B's walked share (``metrics/nn_walk_share.*``)
against a hand-built program record, and against one without the
counters, which reads None as the other program-counter readers do."""
import importlib.util

import pytest

from benchlib import program_trace, trace
from benchlib.harness import Reading
from conftest import BENCH

NAMES = ("nn_walk_share.kitti", "nn_walk_share.pair")


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run():
    return Reading(trace.Trace([], [], (0, 1), 1), [], {})


@pytest.mark.parametrize("name", NAMES)
def test_reads_the_walked_rows_over_the_padded_rows(name, monkeypatch):
    rec = {"spans": [], "stages": [],
           "counters": {"nn.rows_walked": 1047 * 64 * 524 * 128, "nn.rows_full": 131072 ** 2}}
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    assert _reader(name)(_run()) == pytest.approx(100 * 1047 * 64 * 524 * 128 / 131072 ** 2)


@pytest.mark.parametrize("name", NAMES)
def test_every_row_walked_reads_100(name, monkeypatch):
    rec = {"spans": [], "stages": [], "counters": {"nn.rows_walked": 25_000_000,
                                                   "nn.rows_full": 25_000_000}}
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    assert _reader(name)(_run()) == 100.0


@pytest.mark.parametrize("name", NAMES)
def test_without_the_counters_reads_none(name, monkeypatch):
    rec = {"spans": [], "stages": [], "counters": {"trainer.stage.rows_valid": 3}}
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    assert _reader(name)(_run()) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_a_record_reads_none(name, monkeypatch):
    from imfnet_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "record")
    assert _reader(name)(_run()) is None
