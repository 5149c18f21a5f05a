"""Stage clocks on the card (``cuda`` marker; each test skips without one):
a graph holds timing events only where it has stages, and a
``PairRegistrar`` pair replayed as a CUDA graph under ``torch.profiler``,
whose stage times (``utils.timer.stage``, timing events captured into the
graph) sum to within 5 % (or 0.2 ms) of the replay's device span in the
profiler's trace, whose spans sit on their profiler ranges, and whose
outputs stay bit-equal to the eager call's. The file imports no JAX.

    python3 -m pytest tests/test_torch_port_trace_card.py -q -p no:cacheprovider
"""
import statistics

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.graphs import jit

STAGES = {"pipeline.pyramid", "pipeline.forward", "pipeline.keypoints",
          "registration.nn", "registration.ransac"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stage clocks are captured only into CUDA graphs")
    return torch.device("cuda")


def graph_spans_ms(prof):
    """[ms from the first to the last device operation of each graph
    launch], in launch order: the operations that share the launch's
    correlation id."""
    events = list(prof.profiler.kineto_results.events())
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.name() == "cudaGraphLaunch" and e.device_type() == DeviceType.CPU)
    ops = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_user_annotation():
            a, b = ops.get(e.correlation_id(), (None, None))
            end = e.start_ns() + e.duration_ns()
            ops[e.correlation_id()] = (e.start_ns() if a is None else min(a, e.start_ns()),
                                       end if b is None else max(b, end))
    return [(ops[c][1] - ops[c][0]) / 1e6 for _, c in launches if c in ops]


@pytest.mark.cuda
def test_stage_times_of_a_replayed_pair_sum_to_its_device_span(card):
    cfg = bench_config().replace(compute_dtype="float32", num_rand_keypoints=400,
                                 ransac_max_iteration=12500,
                                 level_capacity_divisors=(1, 2, 4, 8))
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    graphed, eager = PairRegistrar(cfg, seed=1), PairRegistrar(cfg, seed=1, graphed=False)
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    for i in range(2):                          # eager warm-up, then the capture
        graphed(*args, generator=torch.Generator(device=card).manual_seed(i))
    timer.reset()
    n = 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = []
        for i in range(n):
            out = graphed(*args, generator=torch.Generator(device=card).manual_seed(i))
            got.append({k: v.cpu() for k, v in out.items()})
        torch.cuda.synchronize()
    rec = timer.record()
    timer.reset()
    for i in range(n):
        want = eager(*args, generator=torch.Generator(device=card).manual_seed(i))
        assert all(torch.equal(want[k].cpu(), got[i][k]) for k in want), i
    assert len(rec["stages"]) == n
    for s in rec["stages"]:
        assert set(s["ms"]) == STAGES and s["graph"] == "PairRegistrar.chain"
        assert s["total_ms"] == pytest.approx(sum(s["ms"].values()))
    spans = graph_spans_ms(prof)
    assert len(spans) == n
    for s, span in zip(rec["stages"], spans):
        assert abs(s["total_ms"] - span) <= max(0.05 * span, 0.2), (s, span)
    # each program span against its own profiler range
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in ("graphs.replay", "pipeline.prepare"):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name, got_ranges in ranges.items():
        mine = sorted((a, b) for m, _, a, b in rec["spans"] if m == name)
        assert len(mine) == len(got_ranges) == n
        off = [max(abs(a - ra), abs(b - rb)) for (a, b), (ra, rb) in zip(mine, sorted(got_ranges))]
        assert statistics.median(off) < 100_000, (name, off)


@pytest.mark.cuda
def test_a_graph_holds_timing_events_only_where_it_has_stages(card):
    def plain(x):
        return x * 2 + 1

    def staged(x):
        timer.stage("toy.first")
        y = x * 2
        timer.stage("toy.second")
        return y + 1

    x = torch.arange(1024.0, device=card)
    timer.reset()
    with timer.tracing():
        runs = {fn.__name__: jit(fn) for fn in (plain, staged)}
        for run in runs.values():
            for _ in range(4):               # warm-up, capture, two replays
                assert torch.equal(run(x), x * 2 + 1)
        rec = timer.record()
    timer.reset()
    (plain_graph,) = runs["plain"].graphs.values()
    (staged_graph,) = runs["staged"].graphs.values()
    assert plain_graph.clock.marks == []
    assert [name for name, _ in staged_graph.clock.marks] == ["toy.first", "toy.second", None]
    # its three replays (the second call captures, then replays) are read;
    # the plain graph's never are
    assert [s["graph"].rsplit(".", 1)[-1] for s in rec["stages"]] == ["staged"] * 3
    assert all(set(s["ms"]) == {"toy.first", "toy.second"} for s in rec["stages"])
