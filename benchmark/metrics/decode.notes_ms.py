"""Host ms per batch in `PendingBatch.notes` (the native note decode of
the packed rolls), after the separate `serve.wait` span in which
`PendingBatch.packed` waited for the copy."""


def read(run):
    times = run.spans.get("serve.decode")
    if run.kind != "serve" or not times:
        return None
    return sum(times) / len(times) * 1e3, "ms"
