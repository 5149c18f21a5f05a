"""The harness: finds a cell's files by name, drives its driver through
set-up, the measured window, the traced window and the check, and builds
the result line.

A driver (``drivers/<name>.py``) defines ``Driver(cell, seed, device)``
with

- ``setup()``: builds the program and the traffic, warms up every shape
  the traffic uses;
- ``unit(i, spans)``: the i-th unit of work (a pair, a step, a fragment),
  waiting for its result on the host; returns the unit's latency in
  seconds;
- ``keep(i)``: called after each ``unit(i)`` of the window, outside its
  latency, to keep what the check will compare (a sample drawn from the
  seed);
- ``work(i)``: the i-th unit's shapes for ``benchlib.arith``;
- ``release()``: frees the program's state once the window has closed;
- ``check()``: the numbers compared, ``[(name, value, limit)]``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchlib import arith
from benchlib import trace as tracing


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its workload and configuration
    files."""

    def __init__(self, root: Path, manifest: Dict, name: str):
        entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"benchmark: no cell {name!r} in BENCHMARK.json")
        bench = root / "benchmark"
        self.root, self.name, self.chips = root, name, entry["chips"]
        self.workload = json.loads((bench / "workloads" / f"{name}.json").read_text())
        cfg = next(c for c in manifest["configs"] if c["name"] == entry["config"])
        self.config = json.loads((root / cfg["file"]).read_text())
        # a cell may set the program's padding knobs for its entry point
        self.config["program"]["overrides"].update(self.workload.get("program_overrides", {}))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.driver_path = bench / "drivers" / f"{self.workload['driver']}.py"
        self.metric_dir = bench / "metrics"

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        return cls(root, json.loads((root / "BENCHMARK.json").read_text()), name)

    def driver(self, seed: int, device):
        mod = _load_module(self.driver_path, f"bench_driver_{self.workload['driver']}")
        return mod.Driver(self, seed, device)


class Reading:
    """What a per-layer metric's reader sees: the traced window, the work
    of the units traced, the untraced window's host spans."""

    def __init__(self, trace, work, spans):
        self.trace, self.work, self.spans = trace, work, spans
        self.notes: List[str] = []

    def median_ms(self, span: str) -> Optional[float]:
        s = self.spans.get(span)
        return None if not s else 1e3 * statistics.median(s)

    def note(self, msg: str) -> None:
        self.notes.append(msg)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def _card() -> Dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[:1]}


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> Dict:
    torch.set_num_threads(min(4, torch.get_num_threads()))
    on_card = torch.device(device).type == "cuda"
    drv = cell.driver(seed, torch.device(device))
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    spans = tracing.Spans()
    latencies: List[float] = []
    attempted = failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        attempted += 1
        try:
            latencies.append(drv.unit(attempted - 1, spans))
        except Exception as e:  # a unit that raises is failed, and ends the window
            failed += 1
            print(f"benchmark: unit {attempted - 1} raised {type(e).__name__}: {e}",
                  file=sys.stderr)
            break
        drv.keep(attempted - 1)
    window = time.perf_counter() - t0

    reading = None
    if trace and not failed:
        n = int(cell.workload["trace_units"])
        traced = tracing.Spans()
        traced.traced = True
        base = attempted
        tr = tracing.profiled(lambda i: drv.unit(base + i, traced), n)
        reading = Reading(tr, [drv.work(base + i) for i in range(n)], spans.seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drv.release()
    checks = drv.check() if not failed else []
    correct = (not failed and bool(checks)
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))

    metrics: Dict[str, Dict] = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if reading is None:
        done = len(latencies)
        for m in cell.end_to_end:
            how = cell.workload["end_to_end"][m["name"]]
            if how == "setup":
                value = setup_s
            elif how == "rate":
                value = done / window if done else 0.0
            elif how == "p95_ms":
                value = 1e3 * percentile(latencies, 95) if latencies else float("inf")
            else:
                raise ValueError(f"unknown end-to-end reduction {how!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            mod = _load_module(cell.metric_dir / f"{m['name']}.py",
                               "bench_metric_" + m["name"].replace(".", "_"))
            value = mod.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = arith.busy_s(reading.trace)
        dev["window_s"] = (reading.trace.window[1] - reading.trace.window[0]) / 1e9
        result["breakdown"] = tracing.breakdown(reading.trace)
        for msg in reading.notes:
            print(f"benchmark: {msg}", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = dev
    result["card"] = _card() if on_card else {}
    result["units"] = {"window_s": window, "completed": len(latencies),
                       "setup_s": setup_s}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def emit(result: Dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


class Reservoir:
    """A uniform sample of ``n`` of the window's units, drawn from ``rng``
    (a numpy Generator from the seed) as the units come: ``offer(i,
    make)`` keeps ``make()`` for unit i, replacing a kept one, with
    probability n / (i + 1)."""

    def __init__(self, n: int, rng):
        self.n, self.rng, self.kept = n, rng, []

    def offer(self, i: int, make) -> None:
        if len(self.kept) < self.n:
            self.kept.append(make())
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.n:
            self.kept[j] = make()
