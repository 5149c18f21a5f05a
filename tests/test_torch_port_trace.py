"""The program's tracing (``utils.timer``) on the CPU: spans, their parents
and their clock against ``torch.profiler``'s ranges, the counters of a
``PairRegistrar`` call, the bucketed extractor and ``batch_to_device``, and
stage boundaries, which do nothing outside a CUDA graph's capture (the
card's side: ``tests/test_torch_port_trace_card.py``)."""
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch, synthetic_pair
from imfnet_tpu_torch.eval.extract import DEFAULT_BUCKETS, make_bucketed_extractor, \
    pad_points_bucketed
from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.train.trainer import batch_to_device, build_model_from_config
from imfnet_tpu_torch.utils import timer


@pytest.fixture(autouse=True)
def _fresh_record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timer.reset()
    yield
    timer.reset()
    torch.set_num_threads(n)


def _names(rec):
    return [s[0] for s in rec["spans"]]


def test_nothing_is_recorded_without_a_profiler_or_a_tracing_block():
    assert not timer.active()
    assert timer.span("a.b") is timer.span("c.d")      # the shared null context
    with timer.span("a.b"):
        timer.count("a.b.rows", 3)
        timer.stage("a.stage")
    assert timer.record() == {"spans": [], "counters": {}, "stages": []}


def test_spans_nest_and_name_their_parent():
    with timer.tracing():
        assert timer.active()
        with timer.span("outer.stage"):
            with timer.span("inner.stage"):
                with timer.span("inner.stage.read"):
                    pass
            with timer.span("inner.other"):
                pass
    assert not timer.active()
    spans = {s[0]: s for s in timer.record()["spans"]}
    assert [spans[n][1] for n in ("outer.stage", "inner.stage", "inner.stage.read",
                                  "inner.other")] == [None, "outer.stage", "inner.stage",
                                                      "outer.stage"]
    for child, parent in (("inner.stage", "outer.stage"), ("inner.stage.read", "inner.stage"),
                          ("inner.other", "outer.stage")):
        assert spans[parent][2] <= spans[child][2] <= spans[child][3] <= spans[parent][3]
    assert timer.record()["counters"] == {}
    timer.reset()
    assert timer.record() == {"spans": [], "counters": {}, "stages": []}


def test_a_span_is_stamped_on_the_clock_of_its_profiler_range():
    n = 12
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timer.active()
        for i in range(n):
            with timer.span(f"clock.span{i}"):
                torch.ones(64).sum()
    assert not timer.active()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    spans = timer.record()["spans"]
    assert len(spans) == n and set(ranges) == {s[0] for s in spans}
    off = [max(abs(ranges[name][0] - a), abs(ranges[name][1] - b)) for name, _, a, b in spans]
    # each range opens just after its span's stamp and closes just before
    # it (the median: a loaded test machine may preempt one span)
    assert statistics.median(off) < 1_000_000, off


def _registrar():
    cfg = bench_config().replace(compute_dtype="float32", num_rand_keypoints=400,
                                 ransac_max_iteration=12500,
                                 level_capacity_divisors=(1, 2, 4, 8))
    return PairRegistrar(cfg, device="cpu", seed=1)


def test_the_counters_add_up_over_a_registrar_call():
    reg = _registrar()
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    q = reg.quantize(reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1))
    n_vox, n_pad = int(q.sv.num_valid), q.sv.coords.shape[0]
    assert 2 * DEFAULT_BUCKETS[0] <= n_pad and n_vox <= n_pad
    assert timer.record()["spans"] == []
    gen = torch.Generator().manual_seed(0)
    with timer.tracing():
        reg(pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6),
            generator=gen)
    rec = timer.record()
    assert rec["counters"] == {"pipeline.quantize.rows_valid": n_vox,
                               "pipeline.quantize.rows_padded": n_pad}
    parents = {name: parent for name, parent, _, _ in rec["spans"]}
    assert parents == {"extract.pad": "pipeline.prepare", "pipeline.prepare": None,
                       "pipeline.quantize.read": "pipeline.quantize",
                       "pipeline.quantize": None, "pipeline.draws": None}
    assert _names(rec).count("pipeline.quantize.read") == 1
    assert _names(rec).count("extract.pad") == 2
    assert rec["stages"] == []          # the CPU runs no graph: no stage clock


def test_the_bucketed_extractor_counts_its_reads_copies_and_bucket():
    cfg = threedmatch_config(conv1_kernel_size=3, model_n_out=16, compute_dtype="float32",
                             grid_extent=(64, 64, 64), grid_extent_buckets=None,
                             level_capacity_divisors=(1, 2, 4, 8), image_H=24, image_W=32)
    torch.manual_seed(0)
    extract = make_bucketed_extractor(build_model_from_config(cfg).eval(), config=cfg,
                                      buckets=(512, 1024, 2048))
    xyz = (np.random.RandomState(0).randn(1500, 3) * 0.1).astype(np.float32)
    image = np.random.RandomState(5).rand(1, 24, 32, 3).astype(np.float32)
    with timer.tracing():
        raw, n = pad_points_bucketed(xyz, (4096,))
        xyz_down, _ = extract(raw, n, image)
    rec, choice = timer.record(), extract.last
    names = _names(rec)
    assert names.count("extract.read") == 1 + len(choice.tried)
    assert names.count("extract.pad") == names.count("extract.prepare") == 1
    assert names.count("extract.copy_out") == 1
    assert rec["counters"]["extract.rows_valid"] == choice.voxels == len(xyz_down)
    assert rec["counters"]["extract.rows_padded"] == choice.bucket


def test_batch_to_device_counts_the_valid_and_padded_rows():
    batch = synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700,
                            n_pad=2048, image_hw=(24, 32), device="cpu")
    with timer.tracing():
        moved = batch_to_device(batch, torch.device("cpu"))
        batch_to_device(moved, torch.device("cpu"))
    rec = timer.record()
    assert _names(rec) == []
    assert rec["counters"]["trainer.stage.rows_valid"] == 2 * (int(batch.n0) + int(batch.n1))
    assert rec["counters"]["trainer.stage.rows_padded"] == 2 * 2 * 2048


def test_a_stage_boundary_is_a_no_op_outside_a_capture():
    with timer.tracing():
        timer.stage("pipeline.forward")
    assert timer.record()["stages"] == []
