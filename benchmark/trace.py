"""A slice of the measured window under `torch.profiler` (device activity
only), and what the metric readers take from it: every device interval (kernels,
copies, sets) by name, the slice's bounds, the device's busy seconds as
the union of those intervals (a copy overlapping a kernel counts once),
and the idle gaps labelled by the benchmark span open on the host when
each began."""
from __future__ import annotations

import time
from collections import defaultdict


def union_s(intervals, lo: float, hi: float) -> tuple[float, list]:
    """(seconds covered, merged (start, end) list) of us intervals clipped
    to [lo, hi]."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, merged


def idle_gaps(merged, lo: float, hi: float, host_spans) -> dict:
    """{label: idle seconds}: each gap between busy intervals in [lo, hi]
    under the innermost host span open at its start ("none" outside
    them)."""
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = defaultdict(float)
    spans = sorted(host_spans, key=lambda s: s[1])
    active, i = [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        while i < len(spans) and spans[i][1] <= a:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[2] > a]
        label = max(active, key=lambda s: s[1])[0] if active else "none"
        gaps[label] += (b - a) / 1e6
    return dict(gaps)


class Slice:
    """What a traced slice holds once it is closed."""

    def __init__(self, kernels, host_spans, lo, hi, units):
        self.kernels = kernels          # [(name, start us, end us)]
        self.units = units              # batches or steps in the slice
        self.window_s = (hi - lo) / 1e6
        self.busy_s, merged = union_s([(a, b) for _, a, b in kernels],
                                      lo, hi)
        self.gaps = idle_gaps(merged, lo, hi, host_spans)

    def device_s(self, *patterns, exclude=()) -> tuple[float, int]:
        """(seconds, count) of the device intervals whose lower-case name
        holds any of the patterns and none of `exclude`."""
        sec, n = 0.0, 0
        for name, a, b in self.kernels:
            low = name.lower()
            if (any(p in low for p in patterns)
                    and not any(p in low for p in exclude)):
                sec += (b - a) / 1e6
                n += 1
        return sec, n

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for name, a, b in self.kernels:
            by[name] += (b - a) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]


class Tracer:
    """Opens the profiler at `start` and closes it at `stop`. Only the
    device's activity is recorded (CUPTI), so the host runs at its own
    pace; the benchmark's spans are put on the trace's clock by a marker
    launched on an idle device right after the profiler started."""

    def __init__(self, spans, device="CUDA"):
        self.spans = spans
        self.device = device      # the profiler's device type of kernels
        self.slice = None
        self._prof = None

    @property
    def open(self) -> bool:
        return self._prof is not None

    def _sync(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self):
        """Open the profiler; the window's clock starts after this."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        self._sync()
        self._marker_host = time.perf_counter()
        torch.zeros(1, device="cuda" if cuda else "cpu")
        self._sync()
        self.spans.marks = []
        self._t0 = time.perf_counter()

    def stop(self, units: int):
        self._sync()
        t1 = time.perf_counter()
        marks, self.spans.marks = self.spans.marks, None
        self._prof.__exit__(None, None, None)
        events = []
        for e in self._prof.events():
            if (str(getattr(e, "device_type", "")).endswith(self.device)
                    and not getattr(e, "is_user_annotation", False)):
                events.append((e.name, e.time_range.start, e.time_range.end))
        self._prof = None
        if not events:
            return None
        # the first device operation is the marker, launched on an idle
        # device at `_marker_host`
        marker = min(events, key=lambda k: k[1])
        offset = marker[1] - self._marker_host * 1e6
        kernels = [k for k in events if k is not marker]

        def on_trace(t):
            return t * 1e6 + offset

        host = [(n, on_trace(a), on_trace(b)) for n, a, b in marks]
        self.slice = Slice(kernels, host, on_trace(self._t0), on_trace(t1),
                           units)
        return self.slice
