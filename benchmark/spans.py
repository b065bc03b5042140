"""The benchmark's own spans, around its calls into each layer of the
program: host seconds per span name and, while a trace is open, each
span's (name, start, end) on the host clock (`time.perf_counter`), so that
the trace's idle gaps can be labelled by what the host was doing."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.times = defaultdict(list)
        self.marks = None          # a list while a trace is open

    def reset(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.times[name].append(t1 - t0)
            if self.marks is not None:
                self.marks.append((name, t0, t1))
