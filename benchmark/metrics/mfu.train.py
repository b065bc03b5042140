"""Model FLOPs of the traced slice's steps (counts/model.py: every
convolution, transposed convolution, projection, attention band and mel
of the passes each step runs, from shapes) over the slice's seconds on
the host clock and the H100's dense TF32 peak (peaks.TF32_FLOPS), in %.
The slice's seconds end before the profiler's records are read, which the
window's would not."""
from benchmark.peaks import TF32_FLOPS


def read(run):
    s = run.slice
    if run.kind != "train" or s is None or not s.units or s.window_s <= 0:
        return None
    return 100.0 * run.unit_flops * s.units / s.window_s / TF32_FLOPS, "%"
