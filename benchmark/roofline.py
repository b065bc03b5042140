"""A kernel's share of its roofline over the traced slice: the least time
the card needs for the work of every call (each call's larger of FLOPs over
the TF32 peak and bytes over HBM bandwidth, counted from shapes) over the
device time of the kernels that ran it. Returns None where the slice holds
another number of calls than the configuration's calls per unit times the
units, since the work can then not be told."""
from __future__ import annotations

from .peaks import bound_s


def share(run, op: str, patterns, first_patterns=None):
    s = run.slice
    calls = run.calls.get(op)
    if s is None or not calls or not s.units:
        return None
    seconds, _ = s.device_s(*patterns)
    _, launches = s.device_s(*(first_patterns or patterns))
    if launches != len(calls) * s.units or seconds <= 0:
        return None
    bound = sum(bound_s(f, b) for f, b in calls) * s.units
    return 100.0 * bound / seconds, "%"
