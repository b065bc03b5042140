"""Host ms per step taking the next labelled and unlabelled batches from
`prefetch_to_device` (the benchmark's span around each `next`)."""


def read(run):
    times = run.spans.get("loader.next")
    if run.kind != "train" or not times or not run.units:
        return None
    return sum(times) / run.units * 1e3, "ms"
