"""Host ms per batch inside `serve.submit` (the benchmark's span around
it), over every batch submitted in the window: the serving loop's
enqueue (H2D staging, the transcriber's launches, the pack, the copy)."""


def read(run):
    times = run.spans.get("serve.submit")
    if run.kind != "serve" or not times:
        return None
    return sum(times) / len(times) * 1e3, "ms"
