"""The traced window's device timeline, from ``torch.profiler``'s trace.

The harness wraps each call in its own spans (``record_function``):
``api.<entry>`` (the call into the program), ``sample`` (the rows kept for
the correctness check and the count of non-finite answers), ``pool`` (the
next batch of states) and ``sync`` (``torch.cuda.synchronize``). A device operation belongs to the span its launch was
issued in, matched through the profiler's correlation ids. Nothing here
reads the program: it reads the trace.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

# device activities; "gpu_user_annotation" rows repeat the spans on the
# device's timeline and are no work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's spans around each call
POOL, SYNC, SAMPLE = "pool", "sync", "sample"
SPANS = (POOL, SYNC, SAMPLE)


def api_span(entry: str) -> str:
    return f"api.{entry}"
# the layout copies and concatenations PyTorch runs for a call: its copy
# kernels, its cat kernel and device-to-device memcpy
BOUNDARY = re.compile(r"copy|Copy|CatArray|cat_|Memcpy")


@dataclass
class Timeline:
    """What a traced window held, in seconds."""

    window_s: float = 0.0
    busy_s: float = 0.0
    api_s: float = 0.0          # device time of operations an api span issued
    boundary_s: float = 0.0     # of those, the layout copies and cats
    ops: dict = field(default_factory=dict)     # name → seconds, the window
    gaps: list = field(default_factory=list)    # (host span, seconds)

    @property
    def program_s(self) -> float:
        """Device time of the program's own operations."""
        return self.api_s - self.boundary_s


def export_events(prof) -> list:
    """The profiler's events, by way of a chrome trace in the temporary
    directory (removed before this returns)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """The harness's spans, which follow one another without overlapping:
    which holds a time, by bisection."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t):
        """The name of the span holding time t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return None


def timeline(events, api_span: str) -> Timeline:
    """Read one window: its length from its first span's start to its last
    span's end, the device's busy time inside it (the union of device
    operations), device time by operation, the api spans' device time split
    into layout copies and the rest, and the idle gaps named by the host
    span each falls in."""
    names = SPANS + (api_span,)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("name") in names
             and e.get("cat") == "user_annotation"]
    if not spans:
        return Timeline()
    t0 = min(s for s, _, _ in spans)
    t1 = max(e for _, e, _ in spans)
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
            corr = e["args"].get("correlation")
            if corr is not None:
                launch[corr] = e["ts"]
    held = _Spans(spans)
    out = Timeline(window_s=(t1 - t0) * 1e-6)
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s, end = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if end <= s:
            continue
        busy.append((s, end))
        sec = (end - s) * 1e-6
        out.ops[e["name"]] = out.ops.get(e["name"], 0.0) + sec
        issued = launch.get(e.get("args", {}).get("correlation"))
        if issued is not None and held.at(issued) == api_span:
            out.api_s += sec
            if BOUNDARY.search(e["name"]):
                out.boundary_s += sec
    merged = _union(busy)
    out.busy_s = sum(e - s for s, e in merged) * 1e-6
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    out.gaps = sorted(((held.at((a + b) / 2) or "host", (b - a) * 1e-6)
                       for a, b in zip(edges[::2], edges[1::2]) if b > a),
                      key=lambda g: -g[1])
    return out


def breakdown(tl: Timeline, top: int = 10, name_chars: int = 160) -> dict:
    """The traced run's ``breakdown``: the device operations that took most
    time (names cut to ``name_chars``) and the longest idle gaps, by the
    host span each fell in."""
    ops = sorted(tl.ops.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:name_chars], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in tl.gaps[:top]]}
