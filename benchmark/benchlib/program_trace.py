"""The program's own record of a traced window, beside the harness's trace.

The program (``imfnet_tpu_torch.utils.timer``) records spans of host work,
counters and the stage times of its CUDA graphs while a profiler runs; the
traced window is the only time one does, so its record is the window's.
Spans are stamped on the profiler's clock (unix nanoseconds), so they line
up with ``run.trace``'s device operations and harness ranges. A program
that keeps no such record gives None here, and so does every reader that
needs it (``metrics/*.py``).
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional, Tuple

from benchlib import trace as tracing

Named = Tuple[str, int, int]        # (name, start_ns, end_ns)


def record() -> Optional[Dict]:
    """The program's record: {"spans", "counters", "stages"}, or None."""
    try:
        from imfnet_tpu_torch.utils import timer
    except ImportError:
        return None
    read = getattr(timer, "record", None)
    return None if read is None else read()


def units(run) -> List[Tuple[int, int]]:
    """Each traced unit's call: the harness's ``bench.call`` ranges."""
    return sorted((a, b) for name, a, b in run.trace.spans if name == "bench.call")


def median_ms_in_units(run, rec: Dict, match: Callable[[str], bool]) -> Optional[float]:
    """The median over the traced units of the ms each unit's call spent
    inside the program spans whose name ``match`` accepts (their union)."""
    spans = [(a, b) for name, _, a, b in rec["spans"] if match(name)]
    calls = units(run)
    if not spans or not calls:
        return None
    return statistics.median(
        tracing.union_ns([(max(a, ca), min(b, cb)) for a, b in spans if a < cb and b > ca]) / 1e6
        for ca, cb in calls)


def innermost(spans: List[Named]) -> List[Tuple[int, int, Optional[int]]]:
    """The time the spans cover, cut where any of them starts or ends:
    (start_ns, end_ns, index of the innermost span open there, the one
    opened last; None where none is open)."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    opening = sorted(range(len(spans)), key=lambda i: spans[i][1])
    out, open_, k = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while k < len(opening) and spans[opening[k]][1] <= a:
            open_.append(opening[k])
            k += 1
        open_ = [i for i in open_ if spans[i][2] > a]
        best = max(open_, key=lambda i: (spans[i][1], -spans[i][2]), default=None)
        out.append((a, b, best))
    return out


def idle_gaps(run) -> List[Tuple[int, int]]:
    """The stretches of the window in which the device ran nothing."""
    tr = run.trace
    return tracing.gaps(tracing.clip(tr.ops, tr.window), tr.window)


def idle_by_span(run, spans: List[Named]) -> Dict[Optional[int], int]:
    """Device-idle ns by the innermost of ``spans`` open over it (its
    index; None: under none of them)."""
    out: Dict[Optional[int], int] = {}
    segs = innermost(spans)
    j = 0
    for ga, gb in idle_gaps(run):
        covered = 0
        while j < len(segs) and segs[j][1] <= ga:
            j += 1
        i = j
        while i < len(segs) and segs[i][0] < gb:
            a, b, who = segs[i]
            part = min(b, gb) - max(a, ga)
            if part > 0 and who is not None:
                out[who] = out.get(who, 0) + part
                covered += part
            i += 1
        out[None] = out.get(None, 0) + (gb - ga) - covered
    return out


def idle_ms_under(run, rec: Dict, name: str) -> Optional[float]:
    """The median over the program spans ``name`` of the device-idle ms
    inside each (what its nested spans do included)."""
    gaps = idle_gaps(run)
    per = [sum(max(0, min(b, gb) - max(a, ga)) for ga, gb in gaps) / 1e6
           for n, _, a, b in rec["spans"] if n == name]
    return statistics.median(per) if per else None


def idle_table(run, rec: Dict) -> Tuple[Dict[str, float], float]:
    """({span name or "outside a span": device-idle ms} by innermost
    span, the share of idle time under a program span or the harness's
    ``bench.result``, in %): the program's spans and the harness's ranges
    on one clock."""
    spans = [(n, a, b) for n, _, a, b in rec["spans"]] + list(run.trace.spans)
    table: Dict[str, float] = {}
    for who, ns in idle_by_span(run, spans).items():
        name = "outside a span" if who is None else spans[who][0]
        table[name] = table.get(name, 0.0) + ns / 1e6
    total = sum(table.values())
    named = sum(ms for n, ms in table.items()
                if n == "bench.result" or not (n.startswith("bench.") or n == "outside a span"))
    return table, (100.0 * named / total if total else 0.0)


def note_idle(run, rec: Dict) -> None:
    """The idle table as a note on standard error."""
    table, share = idle_table(run, rec)
    ms = ", ".join(f"{n} {v:.3f}" for n, v in sorted(table.items(), key=lambda kv: -kv[1]))
    run.note(f"device-idle ms by innermost span: {ms}; under a program span or "
             f"bench.result: {share:.1f} %")


def stage_ms(run, rec: Dict, stage: str) -> Optional[float]:
    """The median over the window's graph replays that have stage
    ``stage`` of its ms (the graph's timing events)."""
    lo, hi = run.trace.window
    replays = [s for s in rec["stages"] if stage in s["ms"] and lo <= s["at_ns"] <= hi]
    if not replays:
        return None
    ms = statistics.median(s["ms"][stage] for s in replays)
    run.note(f"stage {stage}: median {ms:.3f} ms of a replay's "
             f"{statistics.median(s['total_ms'] for s in replays):.3f} ms over "
             f"{len(replays)} replays")
    return ms


def pad_share(rec: Dict, site: str) -> Optional[float]:
    """1 - rows_valid / rows_padded counted at ``site``, in %."""
    padded = rec["counters"].get(f"{site}.rows_padded", 0)
    if not padded:
        return None
    return 100.0 * (1.0 - rec["counters"].get(f"{site}.rows_valid", 0) / padded)
