"""Share of the traced slice in which no device operation runs: one minus
the union of every kernel, copy and set interval over the slice's
length."""


def read(run):
    s = run.slice
    if run.kind != "train" or s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s), "%"
