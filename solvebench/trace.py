"""Reading a `torch.profiler` Chrome trace of the traced solves.

Device work is every event of the categories `kernel`, `gpu_memcpy` and
`gpu_memset`. Busy time is the length of the union of their intervals
inside the traced span; the rest of the span is idle. Each idle gap is
named by what the host was doing when it opened: the innermost host event
(an ATen op, a CUDA runtime call or one of the benchmark's own spans) of
the thread that drives the solves, open at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
SPAN = "solvebench.traced"  # the span around the traced solves
NAME_CHARS = 200  # a kernel's demangled name is cut to this many characters


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def gaps(busy: list[tuple[float, float]], lo: float, hi: float):
    """The idle intervals of [lo, hi) around the disjoint sorted `busy`."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost_timeline(host: list[dict]):
    """(times, labels): from times[i] on, until times[i+1], the innermost
    open host event is labels[i] (None: none open). Events of one thread
    nest, so a stack of open events gives it."""
    times, labels, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            times.append(end)
            labels.append(stack[-1][1] if stack else None)

    for e in sorted(host, key=lambda e: (e["ts"], -e["dur"])):
        close_until(e["ts"])
        stack.append((e["ts"] + e["dur"], e["name"]))
        times.append(e["ts"])
        labels.append(e["name"])
    close_until(float("inf"))
    return times, labels


def label_at(timeline, t: float) -> str:
    times, labels = timeline
    i = bisect.bisect_right(times, t) - 1
    name = labels[i] if i >= 0 else None
    return name if name is not None else "host: python, no op recorded"


def summarize(events: list[dict]) -> dict | None:
    """Busy and idle time of the traced span (µs), device time by kernel
    name and idle time by what the host was doing, both inside the span,
    and (name, duration µs) of every device event of the trace: a kernel
    of the traced solves counts even where the device clock puts its start
    outside the host's span. None if the trace lacks the span."""
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    span = spans[0]
    lo, hi = span["ts"], span["ts"] + span["dur"]
    tid = span.get("tid")
    every = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    dev = [e for e in every if lo <= e["ts"] < hi]
    busy = union(clip(((e["ts"], e["ts"] + e["dur"]) for e in dev), lo, hi))
    busy_us = sum(e - s for s, e in busy)
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and e.get("tid") == tid and e is not span]
    timeline = innermost_timeline(host)
    by_label: dict[str, float] = defaultdict(float)
    for s, e in gaps(busy, lo, hi):
        by_label[label_at(timeline, (s + e) / 2)] += e - s
    by_kernel: dict[str, float] = defaultdict(float)
    for e in dev:
        by_kernel[e["name"][:NAME_CHARS]] += e["dur"]
    outside = [e["name"] for e in every if not lo <= e["ts"] < hi]
    return {"span_us": hi - lo, "busy_us": busy_us,
            "idle_by_host_us": dict(by_label),
            "device_by_name_us": dict(by_kernel),
            "device_events": [(e["name"], e["dur"]) for e in every],
            "outside_span": outside}


def top(d: dict, k: int = 10, scale: float = 1e-6) -> list[list]:
    """The k largest entries of {name: µs}, as [[name, seconds], ...]."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:k]
    return [[name, v * scale] for name, v in items]
